"""Generic VQA evaluation runner (port of ``spatialrgpt_tpu/eval/vqa.py``):
the ``model_vqa`` contract, an image + question jsonl in, an answers jsonl
out, on the batched ``generate`` (its default route: the kernels on the
card).  Images only: no depth, no regions.  ``run_vqa`` runs on the card
unless the caller passes ``device``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from spatialrgpt_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, NUM_TOKENS_PER_IMAGE
from spatialrgpt_tpu_torch.conversation import conv_templates
from spatialrgpt_tpu_torch.data import preprocess as pp
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.data.tokenize import tokenizer_image_token
from spatialrgpt_tpu_torch.eval.common import batch_inputs, cut_at_eos, eval_device, prompt_lengths
from spatialrgpt_tpu_torch.serving.generate import generate


@dataclass
class VQAConfig:
    question_file: str = ""
    image_folder: str = ""
    answers_file: str = "answers.jsonl"
    conv_mode: str = "llama_3"
    batch_size: int = 16
    max_new_tokens: int = 128
    prompt_bucket: int = 1024
    temperature: float = 0.0
    num_chunks: int = 1
    chunk_idx: int = 0


def run_vqa(vcfg: VQAConfig, model, *, device=None) -> str:
    """questions jsonl: {question_id, image, text}; writes {question_id,
    prompt, text, model_id} answer lines (model_vqa.py contract)."""
    dev = eval_device(device)
    tokenizer, net, cfg, processor = model
    with open(vcfg.question_file) as f:
        questions = [json.loads(l) for l in f if l.strip()]
    size = (len(questions) + vcfg.num_chunks - 1) // vcfg.num_chunks
    questions = questions[vcfg.chunk_idx * size : (vcfg.chunk_idx + 1) * size]

    os.makedirs(os.path.dirname(vcfg.answers_file) or ".", exist_ok=True)
    out = open(vcfg.answers_file, "w")

    for start in range(0, len(questions), vcfg.batch_size):
        chunk = questions[start : start + vcfg.batch_size]
        rows, images = [], []
        for q in chunk:
            text = q["text"]
            if DEFAULT_IMAGE_TOKEN not in text:
                text = DEFAULT_IMAGE_TOKEN + "\n" + text
            conv = conv_templates[vcfg.conv_mode].copy()
            conv.append_message(conv.roles[0], text)
            conv.append_message(conv.roles[1], None)
            rows.append(np.asarray(tokenizer_image_token(conv.get_prompt(), tokenizer), np.int64))
            images.append(pp.process_image(os.path.join(vcfg.image_folder, q["image"]), processor,
                                           cfg.image_aspect_ratio))

        sb = expand_rows(
            rows,
            None,
            max_len=cfg.model_max_length,
            tokens_per_image=NUM_TOKENS_PER_IMAGE,
            mask_token_id=cfg.mask_token_id,
            depth_token_id=cfg.depth_token_id,
            pad_to=vcfg.prompt_bucket,
        )
        inputs = batch_inputs(net, sb, np.stack(images), None, None, None, dev)
        result = generate(net, cfg, inputs, prompt_lengths(sb, dev), max_new_tokens=vcfg.max_new_tokens,
                          temperature=vcfg.temperature)
        toks = result.tokens.cpu().numpy()
        for i, q in enumerate(chunk):
            ids = cut_at_eos(toks[i].tolist(), cfg.llm.eos_token_id)
            text = tokenizer.decode(ids, skip_special_tokens=True).strip()
            out.write(
                json.dumps(
                    {
                        "question_id": q.get("question_id", start + i),
                        "prompt": q["text"],
                        "text": text,
                        "model_id": "spatialrgpt-tpu",
                    }
                )
                + "\n"
            )
    out.close()
    return vcfg.answers_file
