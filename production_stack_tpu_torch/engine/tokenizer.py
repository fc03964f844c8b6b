"""Tokenizer, copied from ``production_stack_tpu/engine/tokenizer.py``.

The port serves named configs with ``ByteTokenizer`` — a dependency-free
byte-level tokenizer whose ids fit any vocab >= 260 — so the whole serving
path runs without downloads. HuggingFace tokenizers come with checkpoint
loading (ROADMAP).
"""

from typing import List, Sequence

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.models.config import ModelConfig


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


def get_tokenizer(model: str, model_config: ModelConfig):
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
