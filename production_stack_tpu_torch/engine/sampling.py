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
dispatch computes (the reference's ``runner.LOGPROB_BUCKETS``). Its top-k
is ``top_k_like_jax``: ``jax.lax.top_k``'s selection and order among tied
values, which ``torch.topk`` does not promise.

Speculative decoding: ``speculative_accept`` (linear) and
``speculative_tree_accept`` (token tree) are the reference's deterministic
accept rules, tensor functions with no host read, so they run inside a
captured graph; ``adaptive_gamma`` is the host-side draft-depth policy.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
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
    from. The reference's ``compute_logprobs``, its top-k ids and order
    those of ``jax.lax.top_k`` (``top_k_like_jax``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(logp, 1, chosen.long()[:, None])[:, 0]
    if k <= 0:
        z = logp.new_zeros((logits.shape[0], 0))
        return chosen_lp, z, z.int()
    top_lp, top_ids = top_k_like_jax(logp, k)
    return chosen_lp, top_lp, top_ids.int()


def top_k_like_jax(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis of ``x`` [B, V]: (values [B, k],
    ids [B, k] int64), ordered by value descending and, among equal values,
    by id ascending; among values tied at the k-th place the lowest ids are
    kept. ``torch.topk`` promises neither. The k-th value ``t`` comes from
    ``torch.topk`` (its values are exact whatever its order); every id above
    ``t`` is kept, then the lowest ids equal to ``t`` by a running count over
    the vocabulary; the kept ids are taken in id order and sorted stably by
    value. No host read: it runs inside a captured graph."""
    v = x.shape[-1]
    t = torch.topk(x, k, dim=-1).values[:, -1:]                  # [B, 1]
    above = x > t
    tied = x == t
    need = k - above.sum(dim=-1, keepdim=True)
    keep = above | (tied & (torch.cumsum(tied.int(), dim=-1) <= need))
    ids = torch.arange(v, 0, -1, device=x.device)[None, :]      # V - id
    kept = torch.topk(torch.where(keep, ids, torch.zeros_like(ids)), k,
                      dim=-1).values
    kept = v - kept                                              # id order
    vals = torch.gather(x, -1, kept)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(kept, -1, order)


# ----------------------------------------------------------- speculation
def speculative_accept(
    proposals: torch.Tensor,   # [B, N] draft tokens for positions 1..N
    samples: torch.Tensor,     # [B, N+1] the target's own (seeded) samples
    budget: torch.Tensor,      # [B] tokens the row may still emit
    gamma: Optional[torch.Tensor] = None,  # [B] per-row draft depth cap
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's deterministic accept rule for one linear cycle:
    proposal i is accepted iff it EQUALS the target's own sample at that
    position and every earlier proposal was accepted, so the emitted tokens
    are the target's samples (token-identical to spec-off); proposals at
    index >= gamma[row] count as mismatches. Returns (emit [B], accepted
    [B]) int32: emit = min(accepted + 1, budget) tokens, samples[:emit];
    accepted counts surviving proposals before the budget clip."""
    agree = proposals == samples[:, :-1]                         # [B, N]
    if gamma is not None:
        n = proposals.shape[1]
        agree = agree & (torch.arange(n, device=proposals.device)[None, :]
                         < gamma[:, None])
    accepted = torch.cumprod(agree.int(), dim=1).sum(dim=1).int()
    emit = torch.minimum(accepted + 1, torch.clamp(budget, min=0).int())
    return emit, accepted


# Device copies of a tree's (parents, depths), by device and layout: made
# on the first (eager) call, so a captured call copies nothing from the
# host.
_TREE_CONSTS: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tree_consts(parents, depths, device) -> Tuple[torch.Tensor, torch.Tensor]:
    p = np.asarray(parents, np.int64)
    d = np.asarray(depths, np.int64)
    key = (str(device), p.tobytes(), d.tobytes())
    consts = _TREE_CONSTS.get(key)
    if consts is None:
        consts = _TREE_CONSTS[key] = (torch.from_numpy(p).to(device),
                                      torch.from_numpy(d).to(device))
    return consts


def speculative_tree_accept(
    v_toks: torch.Tensor,   # [B, T] token at each tree node (node 0 = t0)
    z: torch.Tensor,        # [B, T] the target's own sample at each node
    parents,                # [T] numpy (static): ops/tree_mask.py
    depths,                 # [T] numpy (static)
    budget: torch.Tensor,   # [B] tokens the row may still emit
    gamma: torch.Tensor,    # [B] per-row draft depth cap
) -> Tuple[torch.Tensor, ...]:
    """The reference's deterministic tree walk: from the root, emit the
    target's sample at the current node and step to the child whose DRAFT
    token equals it (siblings are distinct, so at most one matches); no
    match ends the walk. Children deeper than gamma[row] are never taken.
    Returns (emit [B], accepted [B], path_idx [B, N+1], main_len [B]):
    emitted tokens are z along path_idx[:emit]; accepted is the walk length
    - 1 before the budget clip; path_idx repeats the last visited node once
    the walk ends; main_len counts the draft-ring entries still valid (the
    draft wrote only the main chain, so a walk onto a sibling keeps t0's
    entry alone)."""
    b = v_toks.shape[0]
    dev = v_toks.device
    n_max = int(np.max(depths))          # main-chain draft depth N
    par, dep = _tree_consts(parents, depths, dev)
    alive = budget > 0
    cur = torch.zeros((b,), dtype=torch.int64, device=dev)
    emit_w = torch.zeros((b,), dtype=torch.int32, device=dev)
    first_child = cur
    cols = []
    for d in range(n_max + 1):
        cols.append(cur)
        emit_w = emit_w + alive.int()
        if d == n_max:
            break                        # deepest nodes have no children
        zc = torch.gather(z, 1, cur[:, None])[:, 0]
        match = ((par[None, :] == cur[:, None])
                 & (v_toks == zc[:, None])
                 & (dep[None, :] <= gamma[:, None])
                 & alive[:, None])
        has = match.any(dim=1)
        nxt = torch.argmax(match.int(), dim=1)
        if d == 0:
            first_child = torch.where(has, nxt, torch.zeros_like(nxt))
        cur = torch.where(has, nxt, cur)
        alive = alive & has
    path_idx = torch.stack(cols, dim=1)                 # [B, N+1]
    accepted = torch.clamp(emit_w - 1, min=0)
    emit = torch.minimum(emit_w, torch.clamp(budget, min=0).int())
    # Node 1 is the main chain's depth-1 node (ops/tree_mask.py layout);
    # sibling branches have no children.
    main_acc = torch.where(first_child == 1, accepted,
                           torch.zeros_like(accepted))
    main_len = torch.minimum(main_acc + 1, emit)
    return emit, accepted, path_idx, main_len


def adaptive_gamma(alpha: float, n_max: int, threshold: float) -> int:
    """The reference's draft-depth policy (host-side, pure): the largest g
    in [0, n_max] with alpha**g >= threshold. threshold > 1 pins gamma to
    0; alpha >= 1 gives n_max."""
    if threshold > 1.0:
        return 0
    if alpha >= 1.0:
        return n_max
    if alpha <= 0.0:
        return 0
    g = 0
    ev = 1.0
    while g < n_max and ev * alpha >= threshold:
        ev *= alpha
        g += 1
    return g
