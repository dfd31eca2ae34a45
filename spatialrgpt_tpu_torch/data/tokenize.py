"""Prompt tokenization with multimodal placeholder tokens.

Behavior-compatible rebuild of ``tokenizer_image_token``
(llava/mm_utils.py:545-570): split the prompt on '<image>', tokenize each
chunk, re-join with IMAGE_TOKEN_INDEX, de-duplicating the BOS token the
tokenizer prepends to every chunk.

The port's own copy of ``spatialrgpt_tpu/data/tokenize.py``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    lstrip: bool = False,
    return_array: bool = False,
):
    """Tokenize ``prompt``, replacing each '<image>' with
    ``image_token_index``.

    When the tokenizer prepends BOS to every chunk, keep exactly the first
    one and drop the rest (offset logic of mm_utils.py:549-566).  With
    ``lstrip`` the leading BOS of the first chunk is dropped too.
    """
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    input_ids: List[int] = []
    offset = 0
    if lstrip:
        offset = 1
    elif chunks and chunks[0] and tokenizer.bos_token_id is not None and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        input_ids.append(chunks[0][0])

    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, c in enumerate(chunks):
        joined.append(c)
        if i < len(chunks) - 1:
            joined.append(sep)

    for chunk_id, x in enumerate(joined):
        if chunk_id == 0 and lstrip:
            input_ids.extend(x)
        else:
            input_ids.extend(x[offset:])

    if return_array:
        return np.asarray(input_ids, np.int64)
    return input_ids
