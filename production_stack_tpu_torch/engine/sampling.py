"""Sampling: request-level params + a batched sampler.

Counterpart of ``production_stack_tpu/engine/sampling.py``. All rows of a
batch are sampled in one call with per-row temperature/top-k/top-p, and the
path is chosen PER ROW so a request's tokens never depend on co-batched
requests:
  * greedy rows (temperature <= 0) use argmax;
  * unfiltered rows use the Gumbel-argmax trick over the full vocab (exact
    softmax sampling, sort-free);
  * filtered rows reduce the vocab to the top TOP_CANDIDATES logits and
    apply the top-k/top-p masks among those candidates.

The Gumbel field is an explicit argument of ``sample_tokens``, so a test can
feed the JAX sampler's own noise to both frameworks. The port draws its
noise from one ``torch.Generator`` per row, seeded with the same uint32 seed
schedule as the JAX package (``token_seed``); it does not reproduce JAX's
threefry bits, so seeded (non-greedy) tokens differ from the JAX package's
(ROADMAP Queue 1 item 3).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

TOP_CANDIDATES = 128  # candidate pool for the filtered (top-k/top-p) branch
SEED_MULT = 1000003


@dataclass
class SamplingParams:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1           # -1 = disabled
    max_tokens: int = 16
    min_tokens: int = 0
    stop: List[str] = field(default_factory=list)
    stop_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False
    seed: Optional[int] = None
    n: int = 1
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @staticmethod
    def from_request(body: dict, default_max_tokens: int = 16) -> "SamplingParams":
        """Build from an OpenAI completion/chat request body; explicit JSON
        ``null`` means "use the default"."""

        def get(key, default):
            v = body.get(key)
            return default if v is None else v

        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            max_tokens = body.get("max_completion_tokens")
        if max_tokens is None:
            max_tokens = default_max_tokens
        stop = get("stop", [])
        return SamplingParams(
            temperature=float(get("temperature", 1.0)),
            top_p=float(get("top_p", 1.0)),
            top_k=int(get("top_k", -1)),
            max_tokens=int(max_tokens),
            stop=[stop] if isinstance(stop, str) else list(stop),
            ignore_eos=bool(get("ignore_eos", False)),
            seed=body.get("seed"),
            n=int(get("n", 1)),
            presence_penalty=float(get("presence_penalty", 0.0)),
            frequency_penalty=float(get("frequency_penalty", 0.0)),
        )


def seed_base(request_id: str, sampling: SamplingParams) -> int:
    """The uint32 seed base a request's token seeds derive from (the
    request's seed, else a hash of its id)."""
    base = sampling.seed if sampling.seed is not None \
        else (hash(request_id) & 0x7FFFFFFF)
    return int(base) & 0xFFFFFFFF


def token_seed(base: int, gen_index: int) -> int:
    """Seed of the token at generation index ``gen_index``: the JAX
    package's ``runner._token_seed`` arithmetic (uint32 wrap-around)."""
    return (int(base) * SEED_MULT + int(gen_index)) & 0xFFFFFFFF


def gumbel_noise(seeds: Sequence[int], vocab: int, device: torch.device,
                 rows: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Per-row Gumbel field [B, V] f32: row i from a generator seeded with
    ``seeds[i]``. Rows with ``rows[i]`` False (greedy) stay zero."""
    out = torch.zeros((len(seeds), vocab), dtype=torch.float32, device=device)
    for i, s in enumerate(seeds):
        if rows is not None and not rows[i]:
            continue
        gen = torch.Generator(device=device)
        gen.manual_seed(int(s))
        # -log(E), E ~ Exp(1), is a standard Gumbel draw.
        out[i].exponential_(generator=gen).log_().neg_()
    return out


def apply_penalties(
    logits: torch.Tensor,      # [B, V]
    counts: torch.Tensor,      # [B, V] int — output-token occurrence counts
    presence: torch.Tensor,    # [B]
    frequency: torch.Tensor,   # [B]
) -> torch.Tensor:
    """OpenAI presence/frequency penalties over OUTPUT tokens."""
    cnt = counts.to(logits.dtype)
    return (
        logits
        - presence[:, None] * (cnt > 0).to(logits.dtype)
        - frequency[:, None] * cnt
    )


def sample_tokens(
    logits: torch.Tensor,       # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,        # [B] int (-1 = off)
    top_p: torch.Tensor,        # [B]
    gumbel: torch.Tensor,       # [B, V] Gumbel noise, one field for both picks
) -> torch.Tensor:
    """Per-ROW path selection (see the module docstring); the filtered
    branch gathers its noise at the candidate indices, so a row's token
    depends only on its own (logits, params, noise). Returns [B] int64."""
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1)

    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    unfiltered_pick = torch.argmax(scaled + gumbel, dim=-1)

    c = min(TOP_CANDIDATES, v)
    cand_logits, cand_idx = torch.topk(scaled, c, dim=-1)         # [B, C] desc
    probs = torch.softmax(cand_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(c, device=logits.device)[None, :]
    k_eff = torch.where(top_k[:, None] <= 0, torch.full_like(top_k[:, None], c),
                        top_k[:, None])
    keep = (ranks < k_eff) & ((cum - probs) < top_p[:, None])
    keep[:, 0] = True
    masked = torch.where(keep, cand_logits,
                         torch.full_like(cand_logits, float("-inf")))
    g_cand = torch.gather(gumbel, -1, cand_idx)                   # [B, C]
    pick = torch.argmax(masked + g_cand, dim=-1)
    filtered_pick = torch.gather(cand_idx, -1, pick[:, None])[:, 0]

    row_filtered = (top_k > 0) | (top_p < 1.0)
    sampled = torch.where(row_filtered, filtered_pick, unfiltered_pick)
    return torch.where(temperature <= 0.0, greedy, sampled)
