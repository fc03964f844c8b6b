"""Tokenizer, copied from ``production_stack_tpu/engine/tokenizer.py``.

A model directory that holds a tokenizer (``tokenizer.json`` or
``tokenizer_config.json``) is served with its HuggingFace tokenizer
(``HFTokenizer``: ``transformers`` is imported here only, and only then;
the chat template is the tokenizer's when it has one). Named configs, and
a directory whose tokenizer does not load (the card's machine has no
``transformers``), get ``ByteTokenizer`` — a dependency-free byte-level
tokenizer whose ids fit any vocab >= 260 — with the JAX package's warning.
"""

import os
from typing import List, Sequence

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class ByteTokenizer:
    """Bytes 0-255 are token ids 0-255; specials above."""

    BOS = 256
    EOS = 257
    PAD = 258

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 260
        self.vocab_size = vocab_size
        self.eos_token_id = self.EOS
        self.bos_token_id = self.BOS

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_special_tokens:
            ids = [self.BOS] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(
        self, messages: List[dict], add_generation_prompt: bool = True, **_
    ) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)


class HFTokenizer:
    """Thin wrapper over a local HuggingFace fast tokenizer."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # lazy; heavy import

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def apply_chat_template(self, messages, add_generation_prompt=True, **kw):
        if self._tok.chat_template:
            return self._tok.apply_chat_template(
                messages, tokenize=False,
                add_generation_prompt=add_generation_prompt, **kw,
            )
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "".join(parts)


def get_tokenizer(model: str, model_config: ModelConfig):
    if os.path.isdir(model) and (
        os.path.exists(os.path.join(model, "tokenizer.json"))
        or os.path.exists(os.path.join(model, "tokenizer_config.json"))
    ):
        try:
            return HFTokenizer(model)
        except Exception as e:  # noqa: BLE001
            logger.warning("HF tokenizer load failed (%s); using ByteTokenizer", e)
    return ByteTokenizer(vocab_size=max(model_config.vocab_size, 260))


class IncrementalDetokenizer:
    """Streams text deltas in O(total_tokens) using a sliding decode window
    (prefix_offset/read_offset scheme); trailing bytes that don't yet form a
    complete UTF-8 character are held back until they do, or until
    ``flush=True``."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, output_token_ids: Sequence[int], flush: bool = False) -> str:
        prefix_text = self._tok.decode(
            output_token_ids[self._prefix_offset:self._read_offset]
        )
        new_text = self._tok.decode(output_token_ids[self._prefix_offset:])
        if not flush and (
            len(new_text) <= len(prefix_text) or new_text.endswith("�")
        ):
            return ""
        delta = new_text[len(prefix_text):]
        self._prefix_offset = self._read_offset
        self._read_offset = len(output_token_ids)
        return delta
