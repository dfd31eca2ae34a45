"""Template-aware tokenization with loss-label masking.

Behavior-compatible rebuild of the reference's preprocessors
(llava/data/dataset.py:159-637): each function renders a conversation with
the active template, tokenizes it (with <image> -> IMAGE_TOKEN_INDEX), and
masks everything but assistant responses with IGNORE_INDEX, reproducing
the reference's round-splitting arithmetic (off-by-one BOS handling
included) so labels match token-for-token.

All outputs are numpy int64 arrays — no torch.

The port's own copy of ``spatialrgpt_tpu/data/templates.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from spatialrgpt_tpu_torch import conversation as conversation_lib
from spatialrgpt_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX
from spatialrgpt_tpu_torch.conversation import SeparatorStyle
from spatialrgpt_tpu_torch.data.tokenize import tokenizer_image_token


def _tok_len(text: str, tokenizer, has_image: bool, lstrip: bool = False) -> int:
    if has_image:
        return len(tokenizer_image_token(text, tokenizer, lstrip=lstrip))
    return len(tokenizer(text).input_ids)


def _render(sources, conv, no_system_prompt=False):
    """Apply the template to a list of {'from','value'} turn lists."""
    if no_system_prompt:
        conv.system = ""
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    extra_systems = []
    for source in sources:
        conv.messages = []
        extra_system = ""
        first_from = source[0]["from"]
        if first_from not in roles:
            if first_from == "system":
                extra_system = source[0]["value"]
            source = source[1:]
        elif roles[first_from] != conv.roles[0]:
            source = source[1:]
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], f"unexpected role order"
            conv.append_message(role, sentence["value"])
        if extra_system:
            conv.system = (
                "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
                + extra_system
            )
        conversations.append(conv.get_prompt())
        extra_systems.append(extra_system)
    return conversations


def _tokenize_all(conversations, tokenizer, has_image):
    rows = []
    for prompt in conversations:
        if has_image:
            ids = tokenizer_image_token(prompt, tokenizer)
        else:
            ids = tokenizer(prompt).input_ids[: tokenizer.model_max_length]
        rows.append(np.asarray(ids, np.int64))
    return rows


# ---------------------------------------------------------------------------
# plain (alignment stage)
# ---------------------------------------------------------------------------


def preprocess_plain(sources, tokenizer) -> Dict:
    """Alignment-stage format: '<image>' + caption + sep; only the caption
    is supervised (dataset.py:552-570)."""
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversations.append(
            source[0]["value"]
            + source[1]["value"]
            + conversation_lib.default_conversation.sep
        )
    input_ids = [
        np.asarray(tokenizer_image_token(p, tokenizer), np.int64) for p in conversations
    ]
    labels = [r.copy() for r in input_ids]
    for target, source in zip(labels, sources):
        tokenized_len = len(tokenizer_image_token(source[0]["value"], tokenizer))
        target[:tokenized_len] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=labels)


# ---------------------------------------------------------------------------
# vicuna v1
# ---------------------------------------------------------------------------


def preprocess_v1(sources, tokenizer, has_image=False, no_system_prompt=False, strict=True) -> Dict:
    conv = conversation_lib.conv_templates["v1"].copy()
    conversations = _render(sources, conv, no_system_prompt)
    input_ids = _tokenize_all(conversations, tokenizer, has_image)
    labels = [r.copy() for r in input_ids]

    sep = conv.sep + conv.roles[1] + ": "
    for conversation, target in zip(conversations, labels):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instruction_len = _tok_len(parts[0], tokenizer, has_image) - 2
            if i > 0:
                round_len -= 1
                instruction_len -= 1
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        # tokenization-mismatch fallback (reference zeroes the sample);
        # strict=False keeps partial labels for tokenizers whose token
        # counts differ from the Llama SentencePiece quirks the
        # reference's arithmetic is calibrated to.
        if strict and cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=labels)


# ---------------------------------------------------------------------------
# llama 2 / mistral
# ---------------------------------------------------------------------------


def preprocess_llama_2(sources, tokenizer, has_image=False, is_mistral=False, strict=True) -> Dict:
    name = "mistral" if is_mistral else "llama_2"
    conv = conversation_lib.conv_templates[name].copy()
    conversations = _render(sources, conv)
    input_ids = _tokenize_all(conversations, tokenizer, has_image)
    labels = [r.copy() for r in input_ids]

    sep = "[/INST]" if is_mistral else "[/INST] "
    for conversation, target in zip(conversations, labels):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image)
            instruction_len = _tok_len(parts[0], tokenizer, has_image) - 2
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        # tokenization-mismatch fallback (reference zeroes the sample);
        # strict=False keeps partial labels for tokenizers whose token
        # counts differ from the Llama SentencePiece quirks the
        # reference's arithmetic is calibrated to.
        if strict and cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=labels)


# ---------------------------------------------------------------------------
# llama 3
# ---------------------------------------------------------------------------


def preprocess_llama_3(
    sources, tokenizer, has_image=False, no_system_prompt=False, strict=True
) -> Dict:
    """Reference dataset.py:249-370; rounds split on <|eot_id|>, first round
    is system+user+gpt, BOS fixed up at the end."""
    conv = conversation_lib.conv_templates["llama_3"].copy()
    conversations = _render(sources, conv, no_system_prompt)
    input_ids = _tokenize_all(conversations, tokenizer, has_image)
    labels = [r.copy() for r in input_ids]

    lstrip = bool(
        has_image
        and len(input_ids[0]) > 0
        and input_ids[0][0] == tokenizer.bos_token_id
    )

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, labels):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for conv_idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx : conv_idx + 2]))
        cur_len = 0
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if i == 0:
                round_len = _tok_len(rou, tokenizer, has_image)
                instruction_len = _tok_len(parts[0], tokenizer, has_image)
            else:
                round_len = _tok_len(rou, tokenizer, has_image, lstrip=lstrip) - 1
                instruction_len = _tok_len(parts[0], tokenizer, has_image, lstrip=lstrip) - 1
            if i < len(re_rounds) - 1:
                round_len += 1  # <|eot_id|>
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        # tokenization-mismatch fallback (reference zeroes the sample);
        # strict=False keeps partial labels for tokenizers whose token
        # counts differ from the Llama SentencePiece quirks the
        # reference's arithmetic is calibrated to.
        if strict and cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX

    # llama3 prompts start with the template's leading token, not BOS;
    # overwrite position 0 with BOS (dataset.py:356-366)
    for ids, target in zip(input_ids, labels):
        if len(ids) and ids[0] != tokenizer.bos_token_id:
            ids[0] = tokenizer.bos_token_id
            target[0] = tokenizer.bos_token_id
    return dict(input_ids=input_ids, labels=labels)


# ---------------------------------------------------------------------------
# mpt / hermes-2
# ---------------------------------------------------------------------------


def preprocess_mpt(sources, tokenizer, has_image=False, no_system_prompt=False, strict=True) -> Dict:
    conv = conversation_lib.conv_templates["mpt"].copy()
    conversations = _render(sources, conv, no_system_prompt)
    input_ids = _tokenize_all(conversations, tokenizer, has_image)
    labels = [r.copy() for r in input_ids]

    sep = conv.sep + conv.roles[1]
    for conversation, target in zip(conversations, labels):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for conv_idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx : conv_idx + 2]))
        cur_len = 0
        for rou in re_rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = _tok_len(rou, tokenizer, has_image) + _tok_len(
                conv.sep, tokenizer, has_image
            )
            instruction_len = _tok_len(parts[0], tokenizer, has_image)
            target[cur_len : cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        # tokenization-mismatch fallback (reference zeroes the sample);
        # strict=False keeps partial labels for tokenizers whose token
        # counts differ from the Llama SentencePiece quirks the
        # reference's arithmetic is calibrated to.
        if strict and cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=labels)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def preprocess(sources, tokenizer, has_image=False, no_system_prompt=False) -> Dict:
    """Dispatch on the active default conversation template
    (dataset.py:573-608)."""
    default = conversation_lib.default_conversation
    if default.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if default.version in ("mpt", "hermes-2"):
        return preprocess_mpt(sources, tokenizer, has_image, no_system_prompt)
    if default.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image)
    if default.sep_style == SeparatorStyle.MISTRAL:
        return preprocess_llama_2(sources, tokenizer, has_image, is_mistral=True)
    if default.sep_style == SeparatorStyle.LLAMA_3:
        return preprocess_llama_3(sources, tokenizer, has_image, no_system_prompt)
    if default.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image, no_system_prompt)
    raise ValueError(f"no preprocessor for template {default.version}")


def set_default_template(name: str) -> None:
    conversation_lib.default_conversation = conversation_lib.conv_templates[name]
