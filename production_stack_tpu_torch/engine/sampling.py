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

The Gumbel field is an explicit argument of ``sample_tokens``. The port
computes it as the JAX package does, bit for bit: row i is
``jax.random.gumbel(jax.random.PRNGKey(seed_i), (V,), float32)`` with the
same uint32 seed schedule (``seed_base``, ``token_seed``), so seeded tokens
equal the JAX package's (see ``gumbel_noise``).

``compute_logprobs`` gives the OpenAI ``logprobs`` fields from the RAW f32
logits (before penalties and temperature), inside the decode train and
after the prefill sample; ``LOGPROB_BUCKETS`` bound the top-k widths a
dispatch computes (the reference's ``runner.LOGPROB_BUCKETS``).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Union

import torch

TOP_CANDIDATES = 128  # candidate pool for the filtered (top-k/top-p) branch
SEED_MULT = 1000003
# Static buckets for a dispatch's top-logprobs width: OpenAI completions
# allow logprobs <= 5, chat top_logprobs <= 20; two buckets bound the
# variant count. 0 = the default variant (no logprobs).
LOGPROB_BUCKETS = (8, 20)

_M32 = 0xFFFFFFFF
# threefry2x32: the rotations of the even and odd groups of four rounds,
# and the key-schedule parity constant.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(torch.finfo(torch.float32).tiny)
# XLA's f32 log on the CPU (Cephes/Eigen ``plog``: the mantissa folded
# into [sqrt(1/2), sqrt(2)), a degree-9 polynomial, ln 2 split in two),
# whose constants these are, read from the LLVM IR that jax's CPU backend
# emits for ``jnp.log`` (``XLA_FLAGS=--xla_dump_to=DIR``).
_SQRT_HALF = float.fromhex("0x1.6a09e6p-1")
_LOG_P = tuple(float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "-0x1.fcba9ep-4", "0x1.23d37ep-3",
    "0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.de4a34p-4", "-0x1.555cap-3",
    "0x1.555554p-2"))
_LN2_LO = float.fromhex("-0x1.bd0106p-13")
_LN2_HI = float.fromhex("0x1.63p-1")


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
    # Top-logprobs width of every output token (0: the chosen token's
    # logprob only); None: no logprobs.
    logprobs: Optional[int] = None
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
        logprobs = body.get("logprobs")
        if logprobs is True:  # chat: a bool, the width in top_logprobs
            logprobs = int(get("top_logprobs", 0))
        elif logprobs is False:
            logprobs = None
        elif logprobs is not None:
            logprobs = int(logprobs)
        return SamplingParams(
            temperature=float(get("temperature", 1.0)),
            top_p=float(get("top_p", 1.0)),
            top_k=int(get("top_k", -1)),
            max_tokens=int(max_tokens),
            stop=[stop] if isinstance(stop, str) else list(stop),
            ignore_eos=bool(get("ignore_eos", False)),
            seed=body.get("seed"),
            n=int(get("n", 1)),
            logprobs=logprobs,
            presence_penalty=float(get("presence_penalty", 0.0)),
            frequency_penalty=float(get("frequency_penalty", 0.0)),
        )


def logprobs_bucket(k: int) -> int:
    """Smallest static top-k bucket covering a requested logprobs width."""
    for b in LOGPROB_BUCKETS:
        if k <= b:
            return b
    return LOGPROB_BUCKETS[-1]


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


def token_seeds(base: torch.Tensor, gen_index: torch.Tensor) -> torch.Tensor:
    """``token_seed`` on the device (the JAX package's
    ``runner._derive_seeds``): uint32 seed bases and generation indices held
    in int64 lanes, the uint32 wrap-around done by a mask. base * SEED_MULT
    stays below 2**52, so no int64 overflow."""
    return (base.long() * SEED_MULT + gen_index.long()) & _M32


def _seed_tensor(seeds, device: torch.device) -> torch.Tensor:
    """Seeds as an int64 tensor on ``device``: a tensor is used as it is
    (the serving path derives its seeds on the device); a host list is
    copied over (tests and checks)."""
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=device, dtype=torch.int64)
    return torch.tensor([int(s) & _M32 for s in seeds], dtype=torch.int64,
                        device=device)


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds), as ``jax._src.prng`` computes it.
    Keys and counts are uint32 values held in int64 lanes; returns the two
    output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl32(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def random_bits(seeds: Union[torch.Tensor, Sequence[int]], n: int,
                device: torch.device) -> torch.Tensor:
    """[len(seeds), n] 32-bit random words (int64 lanes): row i equals
    ``jax.random.bits(jax.random.PRNGKey(seeds[i]), (n,), uint32)`` under
    ``jax_threefry_partitionable=True`` (jax's default since 0.5): the key
    of a uint32 seed is (0, seed), element j hashes the 64-bit count j split
    into (high word, low word) = (0, j) for n < 2**32, and the two output
    words are XOR-ed. Older jax without the partitionable layout hashes
    other counts and is not reproduced."""
    k2 = _seed_tensor(seeds, device)[:, None]
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    b1, b2 = threefry2x32(0, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random's f32 uniform on [tiny, 1) from 32-bit words: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, then
    ``max(tiny, u * (1 - tiny) + tiny)``."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fbits.view(torch.float32) - 1.0
    lo = torch.full((), _F32_TINY, dtype=torch.float32, device=bits.device)
    span = torch.ones((), dtype=torch.float32, device=bits.device) - lo
    return torch.maximum(lo, u * span + lo)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add: the product of two f32 values is exact in
    f64, so one f64 add rounds it once before the final f32 rounding (a
    double rounding, which differs from a true FMA only when the f64 sum
    lands exactly halfway between two f32 values)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of positive finite f32 values, bit for bit as jax's CPU
    backend computes it on an x86 machine with FMA (``torch.log`` is
    correctly rounded and differs from it by an ulp on ~15% of inputs).
    The LLVM backend contracts the polynomial's multiply-adds and the
    ``ln2_lo`` term into FMAs; the other products are exact."""
    x = torch.clamp_min(x, float(torch.finfo(torch.float32).tiny))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = m < _SQRT_HALF
    xr = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = xr * xr
    x3 = x2 * xr
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = _LOG_P
    y0 = _fma(_fma(xr, p0, p1), xr, p6)
    y1 = _fma(_fma(xr, p2, p3), xr, p7)
    y2 = _fma(_fma(xr, p4, p5), xr, p8)
    y = _fma(_fma(_fma(y0, x3, y1), x3, y2), x3, e * _LN2_LO)
    return ((xr - x2 * 0.5) + y) + e * _LN2_HI


def gumbel_noise(seeds: Union[torch.Tensor, Sequence[int]], vocab: int,
                 device: torch.device,
                 rows: Union[torch.Tensor, Sequence[bool], None] = None
                 ) -> torch.Tensor:
    """Per-row Gumbel field [B, V] f32: row i is
    ``jax.random.gumbel(jax.random.PRNGKey(seeds[i]), (V,), float32)``
    (mode "low": ``-log(-log(u))``) where ``rows[i]`` is True; the others
    (greedy) are zero. Bit for bit the JAX package's field on the CPU
    (``xla_log_f32``). Every row is computed and masked on the device, so
    the call reads nothing on the host and can be captured in a CUDA
    graph."""
    u = uniform_from_bits(random_bits(seeds, vocab, device))
    g = -xla_log_f32(-xla_log_f32(u))
    if rows is None:
        return g
    if not isinstance(rows, torch.Tensor):
        rows = torch.tensor(list(rows), dtype=torch.bool, device=device)
    return torch.where(rows.to(device)[:, None], g, torch.zeros_like(g))


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


def sampling_scores(
    logits: torch.Tensor,       # [B, V] float32
    temperature: torch.Tensor,  # [B]
    gumbel: torch.Tensor,       # [B, V] the rows' Gumbel field
) -> torch.Tensor:
    """The score field whose argmax the unfiltered branch of
    ``sample_tokens`` picks: raw logits for greedy rows,
    ``logits / T + Gumbel`` for sampled rows (the reference's
    ``sampling_scores``; speculation ranks alternates by it)."""
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    return torch.where(temperature[:, None] <= 0.0, logits,
                       logits / temp + gumbel)


def compute_logprobs(
    logits: torch.Tensor,  # [B, V] float32
    chosen: torch.Tensor,  # [B] sampled token ids
    k: int,
):
    """(chosen logprob [B], top-k logprobs [B, k], top-k ids [B, k] int32)
    for the OpenAI ``logprobs`` fields, from the RAW logits: the model's
    distribution, not the penalty- and temperature-shaped one it sampled
    from. The reference's ``compute_logprobs``; ``torch.topk`` promises no
    order among equal values, ``jax.lax.top_k`` puts the lower id first."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(logp, 1, chosen.long()[:, None])[:, 0]
    if k <= 0:
        z = logp.new_zeros((logits.shape[0], 0))
        return chosen_lp, z, z.int()
    top_lp, top_ids = torch.topk(logp, k, dim=-1)
    return chosen_lp, top_lp, top_ids.int()
