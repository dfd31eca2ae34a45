"""SpatialRGPT-Bench runner (port of ``spatialrgpt_tpu/eval/spatial_bench.py``).

Loads a composite checkpoint (or takes a preloaded model tuple), builds
region masks from the rle / bbox annotations, runs batched greedy decode
and writes the jsonl answer records that ``eval/judge.py`` scores, field
for field as the reference writes them.

- ``BenchConfig`` and the framework-free helpers (``get_chunk``,
  ``build_prompt``, ``build_round_prompts``, ``stop_str_for``,
  ``masks_for_line``, ``get_model_name``) are the reference's code
  (``tests/test_torch_eval.py`` holds them to it).
- Depth follows the reference protocol: ``DepthPredictor``
  (``models/depth_anything.py``) runs once per unique image, batched by
  image shape, and its colorized map goes through the image processor; a
  depth folder overrides per image; RGB as depth is the explicit
  ``depth_source="rgb"``.  ``depth_model_path`` loads an HF
  ``DepthAnythingForDepthEstimation`` directory into the port's module,
  whose tensors carry the HF names: no conversion.
- ``w8a8`` quantizes the decoder and the tower of a view of the model
  (``ops/layers.py::quantize_model`` on a copy of the module tree that
  shares every tensor it does not replace), so the caller's model stays
  bf16, as the reference builds a new parameter dict.
- Decode is ``serving/generate.py::generate`` with its default route: the
  kernels (K1 in the tower, K2 in prefill, K3 with ``kv_quant``) on the
  card, their plain versions on the CPU.  The reference's default is XLA
  attention.
- ``tp > 1`` raises: tensor-parallel serving waits for the port of
  ``parallel/mesh.py``.

``run_bench`` runs on the card unless the caller passes ``device``.
"""

from __future__ import annotations

import copy
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.conversation import SeparatorStyle, conv_templates
from spatialrgpt_tpu_torch.data import preprocess as pp
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.data.tokenize import tokenizer_image_token
from spatialrgpt_tpu_torch.eval.common import batch_inputs, cut_at_eos, eval_device, prompt_lengths
from spatialrgpt_tpu_torch.ops.layers import quantize_model
from spatialrgpt_tpu_torch.serving.generate import generate


@dataclass
class BenchConfig:
    model_path: str = ""
    annotation_file: str = ""
    image_folder: str = ""
    depth_folder: Optional[str] = None
    answers_file: str = "answers.jsonl"
    conv_mode: str = "llama_3"
    batch_size: int = 32
    max_new_tokens: int = 128
    prompt_bucket: int = 1024
    use_mask: bool = True
    num_chunks: int = 1
    chunk_idx: int = 0
    temperature: float = 0.0
    regions_per_image: int = 8
    kv_quant: bool = False  # int8 KV cache (BASELINE.md: lossless greedy
    # tokens on the test model, halves decode HBM traffic + cache memory)
    w8a8: bool = False  # quantize llm+vision to int8 weights with dynamic
    # int8 activations on expanding kernels (the bench.py serving default;
    # greedy-lossless on the test model — test_w8a8_generate_matches_bf16)
    depth_source: str = "model"  # "model": run Depth-Anything per unique
    # image (the reference's ALWAYS-on protocol, eval_spatial.py:92-106);
    # "rgb": reuse the RGB tensor as fake depth (explicit opt-in only).
    # A depth_folder, when provided, overrides either source per image.
    depth_model_path: str = ""  # HF DepthAnythingForDepthEstimation dir
    # to convert when no predictor instance is passed to run_bench
    tp: int = 1  # tensor-parallel serving: shard the decoder over a


def get_chunk(lst: List, n: int, k: int) -> List:
    """Contiguous chunking (reference data-parallel eval launcher,
    scripts/srgpt/eval/srgpt_bench.sh:23-49)."""
    size = (len(lst) + n - 1) // n
    return lst[k * size : (k + 1) * size]


def build_prompt(conv_mode: str, question: str) -> str:
    conv = conv_templates[conv_mode].copy()
    question, _ = re.subn(r"<mask>", "<mask> <depth>", question)
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def build_round_prompts(conv_mode: str, conversations: List[Dict]) -> List[str]:
    """Per-round prompts with reference accumulation semantics.

    The reference keeps ONE conversation per bench entry and appends each
    round's question to it (eval_spatial.py:200-211); the assistant slots
    are left ``None`` (the model's answers are never inserted), so round
    ``i``'s prompt is the concatenation of questions 0..i with empty
    assistant turns between them.  Crucially, the ``<image>`` token appears
    only in round 0's question — building a fresh conversation per round
    (the round-1 bug) dropped it from every later round.
    """
    conv = conv_templates[conv_mode].copy()
    prompts = []
    for qi in range(len(conversations) // 2):
        question = conversations[qi * 2]["value"]
        question, _ = re.subn(r"<mask>", "<mask> <depth>", question)
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        prompts.append(conv.get_prompt())
    return prompts


def stop_str_for(conv_mode: str) -> str:
    conv = conv_templates[conv_mode]
    return conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2


def masks_for_line(line: Dict, image_aspect_ratio: str, use_mask: bool) -> List[np.ndarray]:
    info = line["image_info"]
    masks = []
    if use_mask and "rle" in line:
        try:
            for rle in line["rle"]:
                m = pp.rle_decode(rle).astype(np.uint8)
                if image_aspect_ratio == "pad":
                    m = pp.pad_to_square_array(m)
                masks.append(m)
            return masks
        except Exception:
            masks = []
    for bbox in line.get("bbox", []):
        h, w = info["height"], info["width"]
        x1, y1, x2, y2 = (int(max(0, min(v, lim))) for v, lim in zip(bbox, (w, h, w, h)))
        m = np.zeros((h, w), np.uint8)
        m[y1:y2, x1:x2] = 1
        if image_aspect_ratio == "pad":
            m = pp.pad_to_square_array(m)
        masks.append(m)
    return masks



# tensors of an HF Depth-Anything checkpoint that the model does not use (the
# reference's converter skips them too)
_DA_UNUSED = ("backbone.embeddings.mask_token",)


def load_depth_anything_dir(path: str, device, dtype=torch.float32):
    """An HF ``DepthAnythingForDepthEstimation`` directory (Depth-Anything
    ViT-L) -> ``DepthAnythingModel`` on ``device``, loaded strictly:
    ``model.safetensors`` (``safetensors`` imported here) or
    ``pytorch_model.bin`` (``torch.load(..., weights_only=True)``).  f32 by
    default, as the reference converts it."""
    from spatialrgpt_tpu_torch.models.depth_anything import DepthAnythingConfig, DepthAnythingModel
    from spatialrgpt_tpu_torch.utils.weights import _empty_model

    st = os.path.join(path, "model.safetensors")
    if os.path.exists(st):
        from safetensors.torch import load_file

        sd = load_file(st)
    else:
        sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu", weights_only=True)
    cfg = DepthAnythingConfig()
    model = _empty_model(DepthAnythingModel, cfg, device, dtype)
    model.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in sd.items() if k not in _DA_UNUSED},
                          strict=True)
    return model, cfg


def _build_depth_predictor(bcfg: BenchConfig, depth_model, device=None):
    """Resolve the eval-time depth source: a ``DepthPredictor``, or None
    when depth comes from the folder / rgb paths."""
    if bcfg.depth_source == "rgb":
        return None
    if bcfg.depth_source != "model":
        raise ValueError(f"unknown depth_source {bcfg.depth_source!r}")
    if depth_model is not None:
        return depth_model
    if bcfg.depth_model_path:
        from spatialrgpt_tpu_torch.models.depth_anything import DepthPredictor

        return DepthPredictor(*load_depth_anything_dir(bcfg.depth_model_path, eval_device(device)))
    raise ValueError(
        "depth_source='model' (the reference protocol) needs a depth "
        "predictor: pass depth_model=, set depth_model_path, or opt out "
        "explicitly with depth_source='rgb' / a depth_folder covering "
        "every image"
    )


def _module_view(module: nn.Module) -> nn.Module:
    """A copy of the module tree (module objects and their tables of
    children, parameters and buffers) that shares every tensor."""
    out = copy.copy(module)
    out._parameters, out._buffers = dict(module._parameters), dict(module._buffers)
    out._modules = {name: None if child is None else _module_view(child) for name, child in module._modules.items()}
    return out


def quantized_view(model: nn.Module) -> nn.Module:
    """The model with its decoder and tower W8A8 (``quantize_llm(...,
    bits=8, act_quant=True)`` on ``llm`` and ``vision``), ``model`` itself
    unchanged: the new int8 weights are the view's own, every other tensor
    is shared."""
    return quantize_model(_module_view(model), bits=8, act_quant=True, vision=True)


def run_bench(bcfg: BenchConfig, model=None, depth_model=None, *, device=None) -> str:
    """Execute the benchmark; returns the answers file path.

    ``model`` may be a preloaded (tokenizer, model, cfg, processor) tuple
    (else ``models/builder.py::load_pretrained_model`` of
    ``bcfg.model_path`` on ``device``); ``depth_model`` a
    ``DepthPredictor``.  The model runs where its tensors lie; the inputs
    go to ``device`` (the card unless given).

    ``bcfg.tp > 1`` serves tensor parallel (the reference's
    ``spatial_bench.py:197-200``) over a process group of ``tp`` ranks, each
    running this function on its own device: a view of the model keeps this
    rank's slice of the decoder (``parallel/mesh.py::tp_shard_model``; the
    caller's model is unchanged) and rank 0 writes the answers."""
    dev = eval_device(device)
    if model is None:
        from spatialrgpt_tpu_torch.models.builder import load_pretrained_model

        model = load_pretrained_model(bcfg.model_path, dev)
    tokenizer, net, cfg, processor = model
    if bcfg.w8a8:
        net = quantized_view(net)
    writer = True
    if bcfg.tp > 1:
        import torch.distributed as dist

        from spatialrgpt_tpu_torch.parallel.mesh import make_mesh, tp_shard_model

        net = tp_shard_model(_module_view(net), make_mesh(tp=bcfg.tp))
        writer = dist.get_rank() == 0

    with open(bcfg.annotation_file) as f:
        questions = json.load(f)
    questions = get_chunk(questions, bcfg.num_chunks, bcfg.chunk_idx)

    os.makedirs(os.path.dirname(bcfg.answers_file) or ".", exist_ok=True)
    ans_file = open(bcfg.answers_file if writer else os.devnull, "w")
    stop_str = stop_str_for(bcfg.conv_mode)

    # one record per (question, conversation round); round i's prompt
    # accumulates questions 0..i and carries no model answers, so all rounds
    # batch independently
    work = []
    for line in questions:
        conversations = line["conversations"]
        prompts = build_round_prompts(bcfg.conv_mode, conversations)
        for qi, prompt in enumerate(prompts):
            work.append(
                (line, qi, prompt, conversations[qi * 2]["value"], conversations[qi * 2 + 1]["value"])
            )

    predictor = None
    for start in range(0, len(work), bcfg.batch_size):
        chunk = work[start : start + bcfg.batch_size]

        # every unique image of the chunk without a precomputed depth file
        # runs through Depth-Anything once (the predictor memoizes by path
        # and batches images of one shape)
        need_depth = {}
        for line, *_ in chunk:
            fp = line["image_info"]["file_path"]
            if bcfg.depth_folder and os.path.exists(
                os.path.join(bcfg.depth_folder, os.path.splitext(fp)[0] + ".png")
            ):
                continue
            if bcfg.depth_source == "model" and fp not in need_depth:
                need_depth[fp] = os.path.join(bcfg.image_folder, fp)
        depth_maps: Dict[str, np.ndarray] = {}
        if need_depth:
            if predictor is None:
                predictor = _build_depth_predictor(bcfg, depth_model, dev)
            from PIL import Image as PILImage

            raws = [np.asarray(PILImage.open(p).convert("RGB")) for p in need_depth.values()]
            cols = predictor.predict_colorized(raws, keys=list(need_depth))
            depth_maps = dict(zip(need_depth, cols))

        records = []
        rows = []
        images, depths, mask_stacks, valids = [], [], [], []
        for line, qi, prompt, q_text, gt in chunk:
            fp = line["image_info"]["file_path"]
            image_path = os.path.join(bcfg.image_folder, fp)
            image = pp.process_image(image_path, processor, cfg.image_aspect_ratio)
            depth = None
            if bcfg.depth_folder:
                dp = os.path.join(bcfg.depth_folder, os.path.splitext(fp)[0] + ".png")
                if os.path.exists(dp):
                    depth = pp.process_depth(dp, processor, cfg.image_aspect_ratio)
            if depth is None and fp in depth_maps:
                # the colorized map goes through the image processor
                from PIL import Image as PILImage

                depth = pp.process_image(PILImage.fromarray(depth_maps[fp]), processor, cfg.image_aspect_ratio)
            if depth is None:
                depth = image.copy()

            raw_masks = masks_for_line(line, cfg.image_aspect_ratio, bcfg.use_mask)
            proc_masks = pp.process_masks(raw_masks, processor, cfg.image_aspect_ratio) if raw_masks else None
            m, v = pp.pad_masks_to_slots(proc_masks, bcfg.regions_per_image, processor.size)

            rows.append(np.asarray(tokenizer_image_token(prompt, tokenizer), np.int64))
            images.append(image)
            depths.append(depth)
            mask_stacks.append(m)
            valids.append(v)
            records.append((line, qi, prompt, q_text, gt))

        sb = expand_rows(
            rows,
            None,
            max_len=cfg.model_max_length,
            tokens_per_image=cfg.tokens_per_image,
            mask_token_id=cfg.mask_token_id,
            depth_token_id=cfg.depth_token_id,
            regions_per_image=bcfg.regions_per_image,
            pad_to=bcfg.prompt_bucket,
        )
        inputs = batch_inputs(net, sb, np.stack(images), np.stack(depths), np.stack(mask_stacks),
                              np.stack(valids), dev)
        result = generate(
            net,
            cfg,
            inputs,
            prompt_lengths(sb, dev),
            max_new_tokens=bcfg.max_new_tokens,
            temperature=bcfg.temperature,
            kv_quant=bcfg.kv_quant,
        )
        toks = result.tokens.cpu().numpy()

        for i, (line, qi, _prompt, q_text, gt) in enumerate(records):
            raw_ids = toks[i].tolist()
            text = tokenizer.decode(cut_at_eos(raw_ids, cfg.llm.eos_token_id), skip_special_tokens=True).strip()
            if text.endswith(stop_str):
                text = text[: -len(stop_str)].strip()
            ans_file.write(
                json.dumps(
                    {
                        "question_id": line["id"],
                        "round": qi,
                        "image": line["image_info"]["file_path"],
                        "question": line.get("text_q", q_text),
                        "pred": text,
                        "output_ids": raw_ids,  # the raw greedy ids, before the eos cut
                        "gt": gt,
                        "model_id": get_model_name(bcfg.model_path),
                        "qa_info": line["qa_info"],
                    }
                )
                + "\n"
            )
    ans_file.close()
    return bcfg.answers_file


def get_model_name(path: str) -> str:
    from spatialrgpt_tpu_torch.models.builder import get_model_name_from_path

    return get_model_name_from_path(path) if path else "spatialrgpt-tpu"
