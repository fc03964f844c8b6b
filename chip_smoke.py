#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``production_stack_tpu_torch``) on one
NVIDIA GPU and check it.

Phases, each printing what it finds (serving, graphs and check run before
the kernel phase, whose profiler would otherwise stay attached during
serving):
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: the paged flash-decode kernels (the tensor-core kernel's bf16
     and f16 variants over pools of q's dtype or int8, the generic kernel's
     bf16 / f16 / f32 over pools of that dtype or int8) compiled by nvcc
     from the checkout (one process per translation unit, all at once);
     per template instance, ptxas's registers, spills and static shared
     memory, the launch's dynamic shared memory and resident blocks per SM;
  3. kernel: one call of each tensor-core variant and of the generic
     float32 one, and of the tensor-core kernel at 24 query heads per kv
     head, at head dim 256 and at one-token pages, captured in a CUDA graph
     and replayed after kv_lens and the block tables change in place (it must
     give the plain version's output on the new inputs, and the captured
     inputs' eager output again bit for bit; each replay counts one launch
     of its variant); then
     ``paged_flash_decode_stats`` (CUDA) against its plain PyTorch
     version on the card, for each variant (bf16 pools; int8 pools with
     bf16 per-slot scales), at llama-3b heads (H=24, Hkv=8, Dh=128) and
     llama-1b heads (H=32, Hkv=4, Dh=64), block size 16, B in {1, 8, 32}
     and the main path's shape, ragged kv_lens (0, 1, 17, >= 4000),
     shuffled block tables, NaN-poisoned slots (bf16) or scales (int8)
     past kv_len and in the block-table padding; faulty plain versions
     must fail the same check (bf16: PV summed in bf16, a row's last value
     dropped; int8: l summed over p * v_scale, K scales read from the
     neighbouring slot); ``paged_attention_decode`` and ``paged_attention``
     must give the kernel's output; device times (torch.profiler) of the
     kernel (per CUDA kernel name; exactly one launch per call), the plain
     version and an SDPA yardstick (CUDA events around replayed graphs of
     its calls; int8: over K/V dequantized beforehand, untimed), the bound
     and the kernel's share of it; then the rest of the domain, each over
     compute-dtype and int8 pools, 4 layers: float32, float16 and bf16 at
     llama-3b heads, head dim 256 (H 12, Hkv 4), 24 query heads over one
     kv head, block size 1, head dim 32 at tiny-llama-8kv's heads (B 8,
     ragged lengths to 4,001), the domain phase's main paths (llama-3b
     float32 and float16; tiny-llama bf16 and float16), and the generic
     kernel's bf16 and float16 at head dim 16; out held in its dtype
     (``OUT_TOLS``: float32 to 1e-4 of each row's norm, float16 to
     6.25e-4, bf16 to 5e-3);
  4. serving, twice: llama-3b at full width, depth cut to ``CUT_LAYERS``
     (``cut_model``'s directory of random bf16 weights from --seed) behind
     the port's HTTP server with its defaults (decode CUDA graphs captured
     at warm-up, the pipelined two-slot loop), with a bf16 KV pool, then
     with an int8 KV pool; each: one
     untimed warm-up request, then 4 concurrent requests (greedy and
     seeded, completions and streamed chat), /v1/models and /health; every
     decode dispatch must replay graphs, and the run's kernel variant must
     launch exactly once per layer and decode step, the other not at all,
     by the kernel's own launch counter on the card (which counts graph
     replays); with ``trace``, the profiler's records of the kernel in one
     more served round are held against the counter;
  5. graphs: per KV dtype, the strict eager loop and the graph + pipeline
     + overlap loop alternated (eager, graph, graph, eager) on the same 4
     requests, on one eager engine and one graph engine (the serving
     phase's config, its KV pool sized from free memory; restarted for
     its second run); the graph runs' warm-up (decode and prefill
     families, graphs, nodes, capture seconds, graph pool and its prefill
     share), tokens equal to the eager loop's bit for bit, no eager decode
     or prefill dispatch, launch counts, a round with a prefill landing
     mid-decode whose fetches overlap; decode ms per step by CUDA events
     and by wall clock, TTFT, aggregate tokens/s, peak memory and the
     step's byte bound for each run. The prefill part, on the graph
     engine: KV blocks with and without the prefill graphs' reserve, the
     reserve against the pool's measured prefill share; 4 x ~64 and 4 x
     ~2,048-token prompts with the prefill graphs set aside (eager) and
     replayed, alternated, tokens bit for bit, TTFT; the largest
     decode-dispatch gap across a landing 2,047-token prompt, eager and
     replayed; one 4-row prefill replayed at b = 8 against b = 4 (an extra
     graph) by CUDA events, and one replay's host ms against one eager
     run's; then the graph tokens against an exact-row engine
     (``max_prefill_seqs`` 4, prefill at b = 4) up to the first step whose
     sampler margin is at most 2 x ``tp_logit_bound``. Then the window
     path with decode_loop="while" on a small model (bf16 and int8
     pools), eager against graphs, bit for bit;
  6. elastic: fast start at the serving config (llama-3b, full width,
     depth cut to ``CUT_LAYERS``, bf16 KV). The serving phase's engine is the cold start (a): its
     weights filled on a background thread beside warm-up, and its
     ``--compilation-cache-dir`` (``ELASTIC_CACHE``, emptied when the script
     starts) gets the warm-up manifest; /metrics' startup gauges give its
     seconds by phase. Before the graphs phase takes (a), it serves the
     elastic rounds: the serving phase's 4 streams x 64 tokens (its prompts
     and seeds), one logprobs request, one with penalties, two logprobs
     requests decoding at b = 2, and one logprobs request of a ~2,000-token
     prompt, each round held until its requests wait. After (a) is gone an
     identical engine (b) starts, finds the manifest, holds a ballast of
     the memory the block cap left spare (so its warm-up and first uses run
     in the room a pool sized from free memory leaves; peak and free bytes
     printed) and captures the default variants only: its deferred count is the
     reference's rule's, its KV blocks (a)'s; the graph pool and its prefill
     share are printed. Its rounds must give (a)'s tokens and logprobs bit
     for bit, the last four each capturing deferred variants at first use
     (seconds and the worker thread's hold printed), no eager decode
     dispatch, the prefill's eager dispatches equal to (a)'s, and the bf16
     kernel's count layers x decode steps (plus one dummy step per decode
     variant captured at first use). The overlap against a serial
     load runs in the ckpt phase on its checkpoint directory;
  7. check: one decode step at llama-3b width (depth cut to 2 layers)
     through the kernel path against the plain window path, over a bf16
     pool and over an int8 pool; the seeded-sampling Gumbel field on the
     card bit for bit against the CPU's;
  7b. domain: the Pallas kernel's whole domain on the engine path. Per
     configuration (llama-3b at full width cut to ``CUT_LAYERS`` in float32
     and in float16; tiny-llama, head dim 32, whole, in bf16; each over
     compute-dtype and int8 pools), an engine with ``attn_impl="paged"``
     and graphs captured at warm-up serves 4 streams (2 greedy, 2 seeded)
     x 32 tokens behind the port's server: no eager decode dispatch, the
     variant of its dtype, pool kind and head dim (the generic kernel's in
     float32, the tensor-core kernel's in bf16 and float16) counted exactly
     layers x decode steps and every
     other variant 0, ``engine.runner.attn_impl == "paged"``; the same 4
     on the engine API from its graphs and through the strict eager train:
     tokens bit for bit; a window-path twin (strict eager, logits kept):
     tokens equal up to the first step whose sampler margin is under 2 x
     ``tp_logit_bound``;
  8. tp: llama-3-8b (Meta-Llama-3-8B shapes, full width, depth cut to
     ``CUT_LAYERS``, random bf16 weights from --seed: ``cut_model``'s
     directory, shared with kvtier-tp) at tensor_parallel_size 2, both ranks on
     this card (rank 1 a worker process; gloo, host-staged), bf16 then
     int8 KV: the tp = 1 runner's greedy tokens forced through the tp = 2
     runners (max |logit diff| within ``tp_logit_bound``, argmax equal
     where tp = 1's top-2 margin exceeds twice it), eager decode ms per
     step of both, the tp = 2 engine behind the HTTP server (4 requests;
     the ranks' token digests agree; each rank's kernel counter reads
     layers x decode steps of the run's variant and 0 of the other; stats), one
     profiled step (host ms in the collectives); then
     ``paged_flash_decode_stats_tp`` on each of 2 ranks against its plain
     twin, and its device times at a rank's shape (H 16, Hkv 4);
  8b. sp: the rest of the reference's mesh, every rank a process on this
     card over gloo. llama-3b at full width, depth cut to ``CUT_LAYERS``,
     bf16: at sequence_parallel_size 2, 4 x 64-token prompts and one of
     3,000 tokens at ``max_num_batched_tokens`` 1,024 (a first chunk and
     two continuation chunks, every one ring-attended); then dp = 2 x sp =
     2 x tp = 2 (8 ranks) and sp = 2 x tp = 3 (6 ranks, the
     replication fallback: kv heads and the MLP replicated, the window
     path), 4 x 16-token prompts. Each: an eager tp = 1 runner's greedy
     tokens forced through the mesh's runner (max |logit diff| within
     ``tp_logit_bound``), the prompts served greedily on the engine API
     (tokens equal to tp = 1's up to the first step whose margin is under
     twice the bound), every rank's ring counts (both kinds where the long
     prompt ran), pool digest (equal to its (0, 0, t) twin's) and kernel
     count (layers x decode steps; 0 on the window path); the long
     prefill's seconds at sp = 2 and tp = 1, the ring's host seconds,
     eager decode ms per step by events, peak GiB per rank;
  9. surface: llama-3b (full width, depth cut to ``CUT_LAYERS``: the
     directory kvtier loads; random bf16 weights, bf16 KV
     of 2049 blocks, decode graphs with their logprob variants captured)
     behind the port's server with an API key and a queue bound: /version,
     401 without the key, the router's /metrics series before traffic;
     after an untimed priming round, the same 4 streams (2 plain, 1
     completions logprobs 5, 1 chat top_logprobs 5) with logprobs off and
     on: tokens equal bit for bit, no eager decode dispatch, the kernel's
     count layers x decode steps, well-formed logprobs (greedy: chosen = top-1),
     /metrics mid-round and after; a top_logprobs 20 request served eagerly;
     n = 2 and a 2-prompt completion; resume from a stream's pstpu payload
     (equal tokens reported at llama-3b bf16, cut); the logprob ops' device time;
     drain with a stream in flight (every block returned); before the
     drain, the observability steps: the same streams with the flight
     recorder and an OTLP tracer (a localhost collector) on, off, off, on
     (each on round's ``/debug/requests/{x-request-id}`` phases cover the
     request and name its decode dispatches, ``/debug/timeline`` lists it,
     its spans sit under the client's ``traceparent``, none dropped), one
     round in a ``POST /debug/profile`` window (a second arm 409, the
     trace's paged-kernel records against its counter), /v1/embeddings of
     the prompts while a round decodes (tokens unchanged; norms, alone
     against batched, rerank scores against dot products; embed and rerank
     ms) and a forced ``tool_choice`` streamed and not (the same message);
     then, on the engine API, logprobs from graphs + pipeline against the
     strict eager loop on the same batches, bit for bit; and resume on
     tiny-llama-128dh in float32, identical;
 10. kvtier: the port's cache server (``kv_offload/server.py``,
     ``--force-python``: the phase needs its batched, prewarm and lease
     ops) as a process, then per KV dtype (bf16, then int8) llama-3b (full width,
     depth cut to ``CUT_LAYERS``: a checkpoint directory of random bf16
     weights from --seed, ``cut_model``; block 16, 1024 blocks, decode and
     prefill graphs captured) with the host and remote tiers: 4 streams sharing a
     ~2048-token prefix served cold, then from the device prefix cache (the
     twin), then after ``reset_prefix_cache`` restored from the host pool
     (tokens equal the twin's bit for bit); a second engine process on the
     same server restores them from the remote tier, and a fresh engine
     there takes ``POST /prewarm`` and serves them from the device prefix
     cache (both equal the twin); ``/prefix_index`` against
     ``prefix_digest``; ``read_blocks`` / ``write_blocks`` GB/s against a
     plain pinned copy of the same bytes; a prefill-role and a decode-role
     engine launched by ``launch.py`` (the prefill engine without a prefix
     cache) serve 4 chat requests over both hops as the router drives them
     (tokens equal the unified engine's on the same request; the decode
     engine replays its graphs, its kernel count read from
     ``/debug/kernels``; the prefill engine forms no decode batch), and
     with the router phase the port's router sends them again (round (c)
     below); decode ms per step with spilling on and off, alternated. In
     every round: no eager decode dispatch, the kernel's count layers x
     decode steps, every spill, restore and handoff failure counter 0;
     then kvtier-tp, the tier at tp = 2: per KV dtype (bf16, then int8)
     llama-3-8b (full width, depth cut to ``CUT_LAYERS``, random bf16
     weights from --seed, block 16, 1024 blocks) at tp = 2 with both ranks
     on this card, with the
     host and remote tiers of its own cache server: the same 4 prompts x
     16 tokens (2 greedy, 2 seeded) cold, from the device prefix cache (the
     twin) and after ``reset_prefix_cache`` from the host pool (= the twin
     bit for bit); ``/prefix_index`` against ``prefix_digest``; whole-block
     ``read_blocks`` / ``write_blocks`` GB/s at tp = 2 (with the gloo
     exchange's host seconds) and tp = 1 against a pinned copy; the twin's
     tokens forced through the engine with its prefix restored from the
     host pool (restored blocks = the tier's blobs byte for byte): the
     reference logits; a fresh tp = 2 engine in a second process restores
     from the remote tier (= the twin bit for bit); a fresh tp = 1 engine
     restores the tp = 2 blobs: forced logits within ``tp_logit_bound`` of
     the reference, argmax equal where its top-2 margin exceeds twice the
     bound, and its served tokens equal the twin's up to a step whose
     margin is at most twice the bound; a tp = 2 prefill / tp = 1 decode
     pair from ``launch.py`` under the same token bar. Each tp = 2 rank's
     counter reads layers x its decode steps of the run's variant and 0 of the
     other; every failure counter 0; then kvtier-native: ``native/kv_server.cpp``
     built by ``make -C native`` into a temporary directory (or the
     Makefile's compiler line), and per server, the Python one and then the
     port's server running the binary it finds on ``PATH`` (it answers a multi-get STATUS_ERROR), one llama-3b engine
     (``CUT_LAYERS``, bf16 KV, the remote tier alone) serving the 4 prompts
     cold and again after ``reset_prefix_cache``, restored from the tier:
     restored tokens and the stored blobs equal across the two servers,
     TTFT of each restore;
 11. spec: speculative decoding, two pairs at full width, depth cut to
     ``CUT_LAYERS`` (random bf16 weights
     from --seed, bf16 KV, block 16, N = 4): llama-3b drafting
     for itself (the ceiling) and a llama-3b draft for llama-3-8b (the
     floor); per pair spec off (the paged kernel, its count layers x
     decode steps), linear, tree (W = 3) and adaptive, each an engine
     behind the HTTP server with its graphs captured at warm-up, serving
     the same 4 streams (2 greedy, 2 seeded) x 64 tokens: ms per dispatch
     and per token by CUDA events, tok/s, TTFT, acceptance, draft depth,
     tokens per target step, cycles run and live, graph families, pool
     bytes, peak memory, gamma-0 dispatches; it fails on an eager decode
     dispatch after warm-up, a /metrics spec series that differs from
     stats(), graph replays that differ from the strict eager train on the
     same batches, or bf16 tokens that part from spec-off's before a step
     whose sampler margin is under 2 x ``tp_logit_bound``; a profiled round
     of ``SPEC_TRACE_TOKENS`` per request of the self pair's spec off and
     linear (each step's seconds in the summary); the self pair's linear engine
     then serves 4 streams over prompt heads it cached, so each prefill
     catches its draft ring up, against its strict eager twin: every
     catch-up a replay of its bucket's graph, tokens and draft-ring digest
     equal the twin's bit for bit, host ms per catch-up by bucket, replayed
     and eager; then float32 tiny-llama with the
     tiny-llama and tiny-opt drafts, every mode's tokens equal to
     spec-off's bit for bit (one row per engine; spec-off through the
     generic float32 kernel, counted layers x decode steps);
 12. ckpt: llama-3b's random bf16 params from --seed, full width cut to
     ``CUT_LAYERS`` (``cut_model``'s draw), written as an HF
     checkpoint directory (config.json, HF names and [out, in] tensors, two
     safetensors shards and their index, by the port's own writer) under
     the gitignored output directory, removed at the phase's end; the
     engine drawing the same weights from the seed (``load_format`` dummy)
     serves 4 streams (2 greedy, 2 seeded) x 64 tokens
     behind the port's server; an engine made from the server's flags with
     ``--model <dir>`` loads it (seconds, GB/s against a plain read of the
     files, the peak host RSS over the load, the tokenizer class: the byte
     tokenizer, no tokenizer file being written), every leaf equal to the
     written one bit for bit and the config to the cut model's in every field
     but the name, and serves the same 4 streams: tokens equal the named
     config's; the same directory booted again from the server's flags
     with ``--no-overlap-weight-load``, without it, and with it again (all
     finding the manifest the first boot wrote): load seconds, the warm-up seconds beside the
     load and their share of it, start-to-first-token, tokens equal; then
     two PEFT adapters (a: rank 8 on q_proj and v_proj; b:
     rank 16 on all seven projections), each a ``local`` LoraAdapter CR
     that the LoraAdapter controller (``python -m
     production_stack_tpu_torch.controller.lora_main``, against a fake API
     server) copies into its shared directory, loaded with
     ``--lora-modules`` from the paths it reports: /v1/models,
     one batch mixing the base model, a, b and a (the base row equals the
     no-adapter engine's, the adapter rows differ from the base model's),
     graph replay = the eager train = the served round on the engine API,
     no prefix block shared across adapters (hit counters), the stack and
     graph-pool bytes, decode ms per step by CUDA events with and without
     adapters alternated; every round replays graphs only and counts layers x
     decode steps of the bf16 kernel, 0 of int8; last, at llama-3b width
     cut to 2 layers in float32, an adapter row's logits against a model
     with merged weights, W + A.B.alpha/r, within ``CKPT_F32_BOUND``;
 13. opt-tp: facebook/opt-125m at full width and depth (random bf16
     weights from --seed) at tensor_parallel_size 2, both ranks on this
     card over gloo, on the window path: the eager tp = 1 runner's greedy
     run of 4 prompts (32 tokens each) forced through the tp = 2 runner
     (max |logit diff| within ``tp_logit_bound``, argmax equal where tp =
     1's top-2 margin exceeds twice it), eager decode ms per step of both
     and the gloo collectives' host seconds; both engines serve the 4
     prompts x 32 greedy tokens (each stream equal to tp = 1's greedy
     tokens up to the first step whose margin is under twice the bound;
     the ranks' token digests equal; no paged-kernel launch);
 14. spec-dp: llama-3b drafting for itself (N = 4) at
     data_parallel_size 2, both replicas on this card over gloo, against a
     dp = 1 engine on the same weights (full width, ``CUT_LAYERS``), eager:
     linear, tree (W = 3), adaptive and a spec-off control (the paged
     kernel, its count layers x decode steps on each replica); 4
     streams (2 greedy, 2 seeded) x 32 tokens, then a stream over a cached
     prompt head (its draft catch-up runs on both replicas): tokens and
     the speculative counters equal dp = 1's, both replicas' pool and
     draft-ring digests equal; ms per token at dp = 2 and dp = 1;
 15. router: the port's router (``python -m
     production_stack_tpu_torch.router.app``, a CPU process) in front of port
     engines. First the port's ``helm_lite`` renders ``helm/`` in this
     process (PyYAML never loaded): the engine asks for one
     ``nvidia.com/gpu`` and its rendered args, loopback ``--host`` and
     ``--port`` in and the smoke's ``--seed``, ``--num-kv-blocks`` and
     ``--max-num-batched-tokens`` added, parse to ``kvtier_server_args``'
     Namespace. The port, copied alone to a temporary directory as the
     engine image copies it, is installed with one ``pip install
     --target`` into a temporary prefix whose ``bin/pstpu-engine`` links to
     ``pstpu-torch-engine``, as the engine image links it. (a) two unified
     engines start from the rendered container's ``command`` and those args
     (llama-3b at ``CUT_LAYERS``, bf16 KV, 1,024 blocks each, the kvtier
     engines' warm-up manifest) with the prefix alone on ``PYTHONPATH``, a
     working directory and an empty kernel cache outside the checkout:
     each builds the shipped kernel source cold, its ``/debug/kernels``
     names the prefix's package as the one it imported, and its
     ``/proc/<pid>/maps`` shows the library from that cache and no file of
     the checkout; a session router (``launch.launch_router``) before them;
     4 users x 3 rounds of multi-round chat (``benchmarks/multi_round_qa.py``'s shape), 32
     greedy streamed tokens, one request at a time: each user's rounds on one
     engine (its ``/debug/requests/{id}``), rounds 2 and 3 adding prefix-cache
     hits there, the tokens of the same request straight to that engine and
     through the router again equal, each engine's kernel count layers x its
     decode steps, every family of the router's series on ``/metrics`` with
     both engines under ``server``; (b) the same through a cache-aware router
     on the same engines; (c) in the kvtier phase, a disagg router in front of
     its prefill/decode pair: the hand-driven chats' tokens, the decode
     engine's graphs replayed, 4 handoffs; (d) last, user 0's engine
     SIGKILLed after the first token of a 128-token stream: one whole stream
     with a finish reason and no 5xx, the tokens after the cut equal to the
     survivor's greedy continuation of the prompt plus the delivered tokens
     sent straight to it, one resume counted, the dead engine's breaker open
     in ``/health``. Before (d), on the same engines: (e) a router with
     ``--enable-batch-api``, ``--feature-gates
     SemanticCache=true,PIIDetection=true`` and ``--pii-action redact``: a
     JSONL of 4 greedy chats (16 tokens, logprobs) uploaded as multipart
     and run as a batch, each output line's tokens and logprobs equal to
     its twin's straight to an engine (every line run whole on both
     engines first, before the counts are set to 0, so line and twin find
     the same prefix-cache state and the logprobs variant's first-use
     capture is behind them); a stream
     carrying an email equal to its twin whose text holds
     ``[REDACTED:email]``; a chat sent twice answered ``"cached": true``
     the second time with the first body and no engine's kernel count
     moving (one hit, one miss on ``/metrics``); a router in block mode
     answering 400 ``pii_detected``; (f) a router with
     ``--service-discovery k8s`` against a standard-library fake API server
     at the in-cluster HTTPS endpoint (``tests/fake_kube_api.pem``): it
     discovers a ready pod on the second engine's port, serves a chat equal
     to its twin, and drops the pod within 5 s of a ``MODIFIED`` unready
     event (``/v1/models`` empty, a chat 404 as the JAX router answers);
     (g) the StaticRoute operator (``python -m
     production_stack_tpu_torch.controller``) renders a CR naming the second
     engine into its ConfigMap, probes the router's health through the CR's
     Service, and the ConfigMap's ``dynamic_config.json``, written where a
     running router on the first engine watches it, re-points that router
     to the second engine. The engines' kernel counts over (e)-(g) are
     layers x their decode steps. (h) the chart rendered again (the second
     engine's port as ``--k8s-port``, a free router port, namespace
     ``default``) and the router started with exactly its rendered args
     behind a fake in-cluster API server listing one ready pod on the
     second engine with the rendered pod labels: the label selector it
     sends is the rendered one, a 16-token greedy chat through it equals
     its twin, the engines' counts over the round are layers x steps. No
     router or controller process holds memory on the card or has a ``/dev/nvidia*`` file open
     (``nvidia-smi --query-compute-apps``, ``/proc/<pid>/fd``); median TTFT
     and inter-token ms through the router beside the same requests
     straight to the engine.

Stdout carries the card line, one ``<phase> summary {...}`` line of JSON
per phase (timings beside the SM clock nvidia-smi sampled meanwhile) and
the result lines; the detail goes to ``chiprun_out/chip_smoke_detail.log``.
Any failure exits non-zero before the result lines. The last two lines are
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the root of the repository.
"""

import argparse
import asyncio
import atexit
import faulthandler
import gc
import json
import math
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 / fp16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "production_stack_tpu_torch/csrc/paged_decode.cu"
# The TPU kernel each variant replaces: _decode_kernel, and its
# quantized=True branch (int8 scores and weights).
KERNEL_REPLACES = {
    "bf16": "production_stack_tpu/ops/pallas/paged_attention.py:57",
    "int8": "production_stack_tpu/ops/pallas/paged_attention.py:175",
}
TP_KERNEL_REPLACES = ("production_stack_tpu/ops/pallas/paged_attention.py:376 "
                      "paged_flash_decode_stats_tp")
BF16_KV_BLOCKS = 8 * 4096 // 16 + 1   # 8 sequences x 4096 tokens + null block
# Every phase but opt-tp runs its model at full width cut to this many
# layers: serving, graphs, elastic, tp, sp, surface, kvtier, kvtier-tp,
# spec, ckpt, spec-dp and router load checkpoint directories of random bf16
# weights from --seed (``cut_model``), written under the output directory
# and removed at exit. Warm-up graph capture, eager dispatch and the gloo
# collectives of a mesh on one card are host-bound and grow with depth,
# and their cost varies ~1.3x from one machine to the next: at 4 layers
# (and the sp phase's sp = 2 run at 28) the whole script took 832 s on one
# machine and 1,079 s on another once the router phase built, installed
# and cold-built the port, against a 1,200 s limit; at 2, 702 s (NVIDIA
# H100 80GB HBM3, 700 W, as the others). llama-3-8b's tp = 2 meshes
# (``TP_MODEL``: tp, kvtier-tp, the spec phase's cross target) run eagerly,
# two gloo collectives per layer and step, the most depth-bound of all.
CUT_LAYERS = 2
# The prefill token budget (``max_num_batched_tokens``) of the engines of the
# surface, kvtier, kvtier-tp, spec and ckpt phases: their warm-up captures
# the prefill families of chunks up to 512 tokens (33 graphs at llama-3b
# with 4 rows), not up to the default 4,096 (69 graphs), so the script
# stays inside its time limit; serving and graphs keep the server's
# default.
WARM_PREFILL_BUDGET = 512
# out is bf16 in both versions and their fp32 sums differ only in order, so
# they differ by at most one bf16 rounding step (< 2**-7 relative, inside
# OUT_RTOL). A typical |out| is ~0.03 at kv_len in the thousands, so each
# row is also held to its norm: ||out - ref|| / ||ref|| <= OUT_ROW_RTOL.
# A CPU emulation of the kernel's fp32 order gives row errors <= ~5e-4; a
# PV sum rounded to bf16 gives >= ~1.6e-2. The kernel phase runs such
# faulty versions as controls and fails if the check lets one through.
OUT_ATOL = 2e-3
OUT_RTOL = 1e-2
OUT_ROW_RTOL = 5e-3
# float16 out: one f16 rounding step is 2**-10 relative, so the bf16
# bounds shrink 8x. float32 out: no rounding of out at all; the two fp32
# sums over up to ~4,000 tokens differ in order only, by ~sqrt(n) ulps of
# the partial sums (~1e-6 relative), held to 1e-4 of each row's norm: 50x
# tighter than bf16's, and a PV sum rounded to bf16 (the faulty control,
# ~1.6e-2) fails it by far.
OUT_TOLS = {"bfloat16": (OUT_ATOL, OUT_RTOL, OUT_ROW_RTOL),
            "float16": (2.5e-4, 1.25e-3, 6.25e-4),
            "float32": (1e-5, 1e-4, 1e-4)}
STATS_RTOL = 1e-3              # m, l are fp32 in both versions
STATS_ATOL = 1e-5


# Per-request and per-case detail goes to this file (in the repository's
# gitignored output directory); stdout gets one summary line per phase.
DETAIL_LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "chiprun_out", "chip_smoke_detail.log")
_detail = None
_T0 = time.monotonic()
# --compilation-cache-dir of the serving phase's engines, the elastic
# phase's, and kvtier's and ckpt's (the warm-up manifests of their
# configurations): emptied when the script starts, so a rerun on the same
# machine boots cold first.
ELASTIC_CACHE = os.path.join(os.path.dirname(DETAIL_LOG), "elastic-cache")
ELASTIC_TOKENS = 64             # tokens per stream, the streams round
ELASTIC_FIRST_USE_TOKENS = 32   # tokens per stream, the first-use rounds
ELASTIC_LONG_PROMPT = 2000      # ByteTokenizer tokens, the long logprobs round


def fail(msg: str) -> None:
    """Stop the run: the message goes to the detail log, stdout and stderr
    (a reader of either stream's tail sees why), with the calling stack in
    the detail log."""
    import traceback

    log(f"FAIL: {msg}\n{''.join(traceback.format_stack()[:-1])}")
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    """A detail line: to DETAIL_LOG, not stdout."""
    global _detail
    if _detail is None:
        os.makedirs(os.path.dirname(DETAIL_LOG), exist_ok=True)
        _detail = open(DETAIL_LOG, "w")
    # Seconds since the process started: where a phase's time goes.
    _detail.write(f"[{time.monotonic() - _T0:8.2f}] {msg}\n")
    _detail.flush()


def summary(phase: str, obj) -> None:
    """The phase's one summary line of JSON, on stdout (and in the detail
    log)."""
    line = f"{phase} summary {json.dumps(obj)}"
    log(line)
    print(line, flush=True)


class SmMhz:
    """The card's SM clock (MHz), sampled by ``nvidia-smi -lms`` while a
    timed block runs: min, mean and max of the samples ("not read" when
    nvidia-smi gives none)."""

    def __init__(self, period_ms: int = 200):
        self.period_ms = period_ms
        self.samples = []

    def __enter__(self):
        self.samples = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits", f"--loop-ms={self.period_ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return self

        def read():
            for line in self.proc.stdout:
                try:
                    self.samples.append(float(line.strip()))
                except ValueError:
                    pass

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.reader.join(5)
        return False

    def summary(self):
        if not self.samples:
            return "not read"
        return {"min": min(self.samples), "mean": sum(self.samples) / len(self.samples),
                "max": max(self.samples), "n": len(self.samples)}


# ---------------------------------------------------------------- phase 3
# Template instances in the build: the tensor-core kernel's 24 (bf16 q over
# bf16 / int8 pools at Dh 32, 64, 128, 256 with 16 M rows and at Dh 64 / 128
# with 8; f16 q over f16 / int8 pools at Dh 32-256 with 16; int8 pools of
# one-token pages at Dh 128 / 256 for each q dtype), the generic kernel's 6.
KERNEL_INSTANCES = 30


def kernel_instances(pa, ptxas: str):
    """Per template instance of the kernels: ptxas's registers, spills and
    static shared memory, and the launch's dynamic shared memory and
    resident blocks per SM (CUDA occupancy calculator, 128 threads): the
    tensor-core kernel's (q dtype, pool kind and one-token pages, Dh, M
    rows), then the generic kernel's 6 (q in bf16 / f16 / f32 over pools
    of that dtype or int8), whose shared memory follows the call's shapes:
    read at Dh 128, 8 query heads per block, one chunk."""
    import re

    dtypes = {c: d for d, c in pa.DTYPE_CODES.items()}
    insts, cur = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"paged_decode_kernelILi(\d)ELi(\d)ELi(\d+)ELi(\d+)E",
                          m.group(1))
            u = re.search(r"paged_decode_genericILi(\d)ELb([01])E", m.group(1))
            cur = None
            if t is not None:
                dtype, pool = dtypes[int(t.group(1))], int(t.group(2))
                cur = {"variant": pa.MMA[(dtype, pool > 0)],
                       "dtype": str(dtype).removeprefix("torch."), "pool": pool,
                       "Dh": int(t.group(3)), "KG": int(t.group(4))}
            elif u is not None:
                dtype = dtypes[int(u.group(1))]
                cur = {"variant": pa.GENERIC[(dtype, u.group(2) == "1")],
                       "dtype": str(dtype).removeprefix("torch."),
                       "quant": u.group(2) == "1",
                       "Dh": 128, "KG": pa.GENERIC_HEADS}
            if cur:
                insts.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            cur["registers"], cur["static_smem"] = int(m.group(1)), int(m.group(2))
    if len(insts) != KERNEL_INSTANCES:
        fail(f"build: ptxas reported {len(insts)} kernel instances, "
             f"want {KERNEL_INSTANCES}")
    for inst in insts:
        if "pool" in inst:
            blocks, smem = pa.occupancy(inst["dtype"], inst["pool"], inst["Dh"],
                                        inst["KG"])
        else:
            blocks, smem = pa.generic_occupancy(inst["dtype"], inst["quant"],
                                                inst["Dh"], inst["KG"])
        inst.update(dynamic_smem=smem, blocks_per_sm=blocks,
                    warps_per_sm=4 * blocks)
        if blocks < 1:
            fail(f"build: instance {inst} cannot launch")
    return insts


def graph_check(torch, pa, device, seed, main_lens):
    """Capture one call of each variant in a CUDA graph, then change
    kv_lens and the block tables in place and replay: the output must be
    the plain version's on the new inputs (no host decision read device
    data), and replaying the first inputs again must give the eager output
    bit for bit (the merge tickets were reset). The four tensor-core
    variants and one of the generic kernel (float32, the domain phase's) at
    llama-3b heads, then the tensor-core kernel's head groups (G 24), column
    blocks (Dh 256) and one-token pages (the int8 instances of their own),
    each with its own tickets."""
    b = 4
    bf16, f16 = torch.bfloat16, torch.float16
    llama = (24, 8, 128, 16)
    for quant, dtype, (h, hkv, dh, bs), shape in (
            (False, bf16, llama, ""), (True, bf16, llama, ""), (False, f16, llama, ""),
            (True, f16, llama, ""), (False, torch.float32, llama, ""),
            (False, bf16, (24, 1, 128, 16), " G 24"),
            (True, f16, (12, 4, 256, 1), " Dh 256 block size 1"),
            (True, bf16, (24, 8, 128, 1), " block size 1")):
        dname = str(dtype).removeprefix("torch.")
        name = f"graph [{case_label(dname, quant)}]{shape}"
        q, kp, vp, ks, vs, bt, kvl = make_case(torch, b, h, hkv, dh, main_lens, 2,
                                               bs, seed, device, quant, dtype)
        sc = dict(k_scale=ks, v_scale=vs)
        want = pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, 1, block_size=bs, **sc)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            got = pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, 1, block_size=bs, **sc)
        kernels, nodes = pa.graph_node_counts(graph)
        if kernels != 1 or nodes != 1:
            fail(f"{name}: one call captured as {nodes} graph nodes, {kernels} "
                 "of them kernels; the kernel is one launch per call")
        bt0, kvl0 = bt.clone(), kvl.clone()
        pa.reset_launch_counts()
        # Rows rotated by one and shortened (row 0 emptied): other pages,
        # other chunk counts; every position kept is clean in the pool.
        new_lens = [0] + [max(1, main_lens[(i + 1) % b] - 97 * i) for i in range(1, b)]
        bt.copy_(torch.roll(bt0, -1, dims=0))
        kvl.copy_(torch.tensor(new_lens, dtype=torch.int32, device=device))
        graph.replay()
        ro, rm, rl = pa.paged_flash_decode_stats_ref(q, kp, vp, bt, kvl, 1,
                                                     block_size=bs, **sc)
        torch.cuda.synchronize()
        live = kvl > 0
        err, row_rel, ok = out_error(torch, got[0], ro, live)
        ok = (ok and stats_close(torch, got[1][live], rm[live])
              and stats_close(torch, got[2][live], rl[live])
              and bool((got[0][0] == 0).all()) and bool((got[1][0] == float("-inf")).all()))
        if not ok:
            fail(f"{name}: replay with new kv_lens {new_lens} and tables disagrees "
                 f"with the plain version (max abs {err:.3e}, row rel {row_rel:.3e})")
        bt.copy_(bt0)
        kvl.copy_(kvl0)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"{name}: replay of the captured inputs differs from the eager call")
        variant = pa.variant_of(dtype, quant, dh, h // hkv, bs)
        counts = pa.launch_counts()
        if counts != {**dict.fromkeys(pa.VARIANTS, 0), variant: 2}:
            fail(f"{name}: two replays counted {counts}, want 2 of {variant}")
        log(f"{name}: one call is 1 graph node (a kernel); replay with kv_lens "
            f"{new_lens} and rotated tables matches "
            f"the plain version (max abs {err:.3e}, row rel {row_rel:.3e}); "
            "replay of the captured inputs equals the eager call bit for bit; "
            "the kernel counted each of the 2 replays")
        del graph, got, want, q, kp, vp, ks, vs
        torch.cuda.empty_cache()


def make_case(torch, b, h, hkv, dh, kv_lens, n_layers, bs, seed, device,
              quant=False, dtype=None):
    """Pool, shuffled block tables and queries for one kernel case, q in
    ``dtype`` (bf16 by default) over pools of that dtype or int8. Slots
    past each kv_len and the block the table padding points at hold NaN
    (int8: NaN scales over a payload of +-127): a kernel that reads them
    poisons its output. Returns (q, k_pool, v_pool, k_scale, v_scale,
    block_tables, kv_lens); the scales are None without int8."""
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pages = [-(-n // bs) for n in kv_lens]
    mb = 1
    while mb < max(max(pages), 1):
        mb *= 2
    num_blocks = sum(pages) + 2                 # + null block 0 + NaN block
    nan_blk = num_blocks - 1
    perm = torch.randperm(num_blocks - 2, generator=gen, device=device) + 1
    bt = torch.full((b, mb), nan_blk, dtype=torch.int32, device=device)
    ofs = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[ofs:ofs + n].to(torch.int32)
        ofs += n
    shape = (n_layers, hkv, num_blocks * bs, dh)
    k_pool = torch.randn(shape, generator=gen, device=device).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=device).to(dtype)
    k_scale = v_scale = None
    poisoned = [(k_pool, float("nan")), (v_pool, float("nan"))]
    if quant:
        from production_stack_tpu_torch.ops.quantization import quantize_kv

        k_pool, k_scale = quantize_kv(k_pool)
        v_pool, v_scale = quantize_kv(v_pool)
        poisoned = [(k_pool, 127), (v_pool, -127), (k_scale, float("nan")),
                    (v_scale, float("nan"))]
    for pool, bad in poisoned:
        pool[:, :, nan_blk * bs:(nan_blk + 1) * bs] = bad
        for i, n in enumerate(kv_lens):
            if n % bs:
                blk = int(bt[i, n // bs])
                pool[:, :, blk * bs + n % bs:(blk + 1) * bs] = bad
    q = torch.randn((b, h, dh), generator=gen, device=device).to(dtype)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, k_scale, v_scale, bt, kvl


def device_profile(torch, fn, n_calls: int, what: str, per_call=None):
    """Device time of n_calls calls from one torch.profiler trace (host
    gaps excluded): (ms per call summed over every kernel, {kernel name: ms
    per call}, kernel launches per call). A trace with no device time, or
    with another count of launches per call than ``per_call`` (CUPTI can
    drop records), is taken again, up to three times; None when no trace
    recorded any device time (the caller times by CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    found = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n_calls):
                fn(i)
            torch.cuda.synchronize()
        by_name, count = {}, 0
        for evt in prof.events():
            if str(evt.device_type).endswith("CUDA"):
                count += 1
                by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
        total_us = sum(by_name.values())
        if total_us > 0:
            found = (total_us / n_calls / 1e3,
                     {k: v / n_calls / 1e3 for k, v in by_name.items()},
                     count / n_calls)
            if per_call is None or found[2] == per_call:
                return found
    if found is None:
        log(f"{what}: torch.profiler recorded no device time in 3 traces")
    return found


def events_ms(torch, fn, n_calls: int, what: str, reps: int = 5):
    """Device ms per call by CUDA events around ``reps`` replays of one CUDA
    graph of ``n_calls`` calls (no host launch gaps inside), or around an
    eager loop when the calls cannot be captured: (ms, how). For readings
    the profiler loses (CUPTI drops records: a reading below the bound)."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    try:
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(n_calls):
                fn(i)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            for i in range(n_calls):
                fn(i)
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        how = "cuda events, graph replay"
    except RuntimeError as e:
        log(f"{what}: not captured ({e}); timing an eager loop")
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            for i in range(n_calls):
                fn(i)
        end.record()
        how = "cuda events, eager loop"
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_calls), how


def device_ms(torch, fn, n_calls: int, what: str):
    """Mean device time per call (ms), every kernel of the call summed, and
    how it was read: by torch.profiler, or by CUDA events when its traces
    hold no device time."""
    found = device_profile(torch, fn, n_calls, what)
    if found is None:
        return events_ms(torch, fn, n_calls, what)
    return found[0], "torch.profiler"


def bound_of(kv_lens, b, h, hkv, dh, bs, quant=False, elt=2):
    """Least time for the work this input needs: each K/V row of the live
    pages read once (``elt`` B an element in the compute dtype: 2 for bf16
    and f16, 4 for f32; int8: 1 B an element plus the slot's 2-byte bf16
    scale), q read, out/m/l written, the block-table entries in use and
    kv_lens read; operations 4*kv_len*H*Dh (QK and PV) at the card's peak
    for the type (the tensor cores' for bf16 and f16, the CUDA cores' for
    f32)."""
    toks = sum(kv_lens)
    kv_row_bytes = dh + 2 if quant else dh * elt
    nbytes = (toks * hkv * kv_row_bytes * 2 + b * h * dh * elt * 2 + b * h * 4 * 2
              + sum(-(-n // bs) for n in kv_lens) * 4 + b * 4)
    ops = 4 * toks * h * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (F32_FLOPS_PER_S if elt == 4 else BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def out_error(torch, out, ref, live):
    """(max |out - ref|, worst row's ||out - ref|| / ||ref||, passes) over
    the rows with kv_len > 0, against the tolerances of out's dtype
    (``OUT_TOLS``)."""
    atol, rtol, row_rtol = OUT_TOLS[str(out.dtype).removeprefix("torch.")]
    o, r = out.float()[live], ref.float()[live]
    diff = (o - r).abs()
    row_rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)).max().item()
    ok = bool((diff <= atol + rtol * r.abs()).all()) and row_rel <= row_rtol
    return diff.max().item(), row_rel, ok


def plain_with_fault(torch, q, kp, vp, bt, kvl, layer, bs, fault):
    """The plain version with one deliberate fault, to show that the out
    check catches it: "bf16 PV sum" rounds the running PV sum to bf16 after
    each page; "last V dropped" leaves each row's last value out of PV."""
    b, h, dh = q.shape
    hkv = kp.shape[1]
    s_max = -(-max(int(kvl.max()), 1) // bs) * bs
    slots = (bt.long()[:, :, None] * bs
             + torch.arange(bs, device=q.device)).reshape(b, -1)[:, :s_max]
    keys = torch.stack([kp[layer][:, slots[i]] for i in range(b)]).float()
    vals = torch.stack([vp[layer][:, slots[i]] for i in range(b)]).float()
    pos = torch.arange(s_max, device=q.device)[None, :]
    valid = pos < kvl.long()[:, None]                              # [B, S]
    vvalid = valid & (pos != kvl.long()[:, None] - 1) if fault == "last V dropped" \
        else valid
    keys = torch.where(valid[:, None, :, None], keys, 0.0)
    vals = torch.where(vvalid[:, None, :, None], vals, 0.0)
    qf = q.float().reshape(b, hkv, h // hkv, dh) * dh ** -0.5
    s = torch.einsum("bkgd,bksd->bkgs", qf, keys)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if fault == "bf16 PV sum":
        acc = torch.zeros(p.shape[:-1] + (dh,), dtype=torch.bfloat16,
                          device=q.device)
        for t in range(0, s_max, bs):
            acc = (acc.float() + torch.einsum("bkgs,bksd->bkgd", p[..., t:t + bs],
                                              vals[:, :, t:t + bs])).to(torch.bfloat16)
        acc = acc.float()
    else:
        acc = torch.einsum("bkgs,bksd->bkgd", p, vals)
    return (acc / l.clamp(min=1e-30)[..., None]).reshape(b, h, dh).to(q.dtype)


def int8_plain_with_fault(torch, pa, q, kp, vp, ks, vs, bt, kvl, layer, bs,
                          fault):
    """The int8 plain version with one deliberate fault, to show that the
    check catches it: "l over p*v_scale" sums the V-scaled weights into l;
    "K scale of the next slot" reads each slot's K scale from its
    neighbour. Returns (out, m, l)."""
    if fault == "K scale of the next slot":
        # The poisoned (NaN) scales become 0 first, so that the control
        # fails by its arithmetic and not by a NaN rolled into a live slot.
        return pa.paged_flash_decode_stats_ref(
            q, kp, vp, bt, kvl, layer, block_size=bs,
            k_scale=torch.roll(torch.nan_to_num(ks, nan=0.0), -1, dims=2),
            v_scale=vs)
    b, h, dh = q.shape
    hkv = kp.shape[1]
    s_max = -(-max(int(kvl.max()), 1) // bs) * bs
    slots = (bt.long()[:, :, None] * bs
             + torch.arange(bs, device=q.device)).reshape(b, -1)[:, :s_max]
    pos = torch.arange(s_max, device=q.device)[None, :]
    valid = pos < kvl.long()[:, None]                              # [B, S]

    def rows(pool, n_dims):
        x = torch.stack([pool[layer][:, slots[i]] for i in range(b)]).float()
        return torch.where(valid.view(b, 1, s_max, *[1] * n_dims), x, 0.0)

    keys, vals = rows(kp, 1), rows(vp, 1)                          # [B,Hkv,S,Dh]
    ksc, vsc = rows(ks, 0), rows(vs, 0)                            # [B,Hkv,S]
    qf = q.float().reshape(b, hkv, h // hkv, dh) * dh ** -0.5
    sc = torch.einsum("bkgd,bksd->bkgs", qf, keys) * ksc[:, :, None, :]
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pv = torch.exp(sc - m[..., None]) * vsc[:, :, None, :]
    l = pv.sum(dim=-1)
    acc = torch.einsum("bkgs,bksd->bkgd", pv, vals)
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(b, h, dh).to(q.dtype)
    return out, m.reshape(b, h), l.reshape(b, h)


def stats_close(torch, got, want):
    return torch.allclose(got, want, rtol=STATS_RTOL, atol=STATS_ATOL)


def case_label(dtype: str, quant: bool) -> str:
    """A kernel case's pool label: "bf16" / "int8" for bf16 q (the
    tensor-core kernel's two variants), else q's dtype, "/int8" added for
    int8 pools."""
    if dtype == "bfloat16":
        return "int8" if quant else "bf16"
    return {"float16": "f16", "float32": "f32"}[dtype] + ("/int8" if quant else "")


def run_kernel_case(torch, pa, name, b, h, hkv, dh, kv_lens, n_layers, seed,
                    device, quant, bs=16, kernel=None, dtype=None):
    """One kernel case: the kernel (``kernel``, by default
    ``paged_flash_decode_stats``) against its plain version in q's dtype
    (``dtype``, bf16 by default; the tolerances of ``OUT_TOLS``), the fault
    controls, and device times of the kernel, the plain version and SDPA
    (SDPA by CUDA events around replayed graphs of its calls: torch.profiler
    has lost SDPA records in long runs and read it 5x too fast)."""
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.quantization import dequantize_kv

    dtype = dtype or torch.bfloat16
    dname = str(dtype).removeprefix("torch.")
    q, kp, vp, ks, vs, bt, kvl = make_case(torch, b, h, hkv, dh, kv_lens,
                                           n_layers, bs, seed, device, quant,
                                           dtype)
    sc = dict(k_scale=ks, v_scale=vs)
    kernel = kernel or pa.paged_flash_decode_stats
    max_err = max_row_rel = 0.0
    controls = {}
    for layer in sorted({0, n_layers - 1}):
        out, m, l = kernel(q, kp, vp, bt, kvl, layer, block_size=bs, **sc)
        ro, rm, rl = pa.paged_flash_decode_stats_ref(q, kp, vp, bt, kvl, layer,
                                                     block_size=bs, **sc)
        torch.cuda.synchronize()
        for i, n in enumerate(kv_lens):
            if n == 0:
                if not (torch.all(out[i] == 0) and torch.all(m[i] == float("-inf"))
                        and torch.all(l[i] == 0)):
                    fail(f"{name}: kv_len=0 row {i} is not (0, -inf, 0)")
        live = kvl > 0
        for t, what in ((out[live], "out"), (m[live], "m"), (l[live], "l")):
            if not torch.isfinite(t).all():
                fail(f"{name} layer {layer}: non-finite {what} (a masked or "
                     "padding slot leaked into the result)")
        err, row_rel, ok = out_error(torch, out, ro, live)
        if not ok:
            fail(f"{name} layer {layer}: kernel out disagrees with plain version: "
                 f"max abs {err:.3e}, row rel {row_rel:.3e} (atol, rtol, row "
                 f"rtol {OUT_TOLS[dname]})")
        try:
            torch.testing.assert_close(m[live], rm[live], rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
            torch.testing.assert_close(l[live], rl[live], rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
        except AssertionError as e:
            fail(f"{name} layer {layer}: kernel stats disagree with plain version: {e}")
        max_err = max(max_err, err)
        max_row_rel = max(max_row_rel, row_rel)
        if layer == 0 and quant:
            for fault in ("l over p*v_scale", "K scale of the next slot"):
                bo, bm, bl = int8_plain_with_fault(torch, pa, q, kp, vp, ks, vs,
                                                   bt, kvl, 0, bs, fault)
                c_err, c_row, c_ok = out_error(torch, bo, ro, live)
                c_ok = (c_ok and stats_close(torch, bm[live], rm[live])
                        and stats_close(torch, bl[live], rl[live]))
                controls[fault] = c_row
                if c_ok:
                    fail(f"{name}: control '{fault}' passed the out/m/l check "
                         f"(max abs {c_err:.3e}, row rel {c_row:.3e}): the "
                         "tolerance is too loose to see that fault")
                del bo, bm, bl
        elif layer == 0:
            for fault in ("bf16 PV sum", "last V dropped"):
                bad = plain_with_fault(torch, q, kp, vp, bt, kvl, 0, bs, fault)
                c_err, c_row, c_ok = out_error(torch, bad, ro, live)
                controls[fault] = c_row
                if c_ok:
                    fail(f"{name}: control '{fault}' passed the out check "
                         f"(max abs {c_err:.3e}, row rel {c_row:.3e}): the "
                         "tolerance is too loose to see that fault")
                del bad
        if layer == 0 and name.startswith("main path"):
            # The single-layer wrapper and the by-shape dispatch reach the
            # same kernel: their output is the kernel's, bit for bit.
            one = dict(k_scale=ks[0], v_scale=vs[0]) if quant else {}
            dec = pa.paged_attention_decode(q[:, None], kp[0], vp[0], bt, kvl,
                                            block_size=bs, **one)
            disp = pa.paged_attention(q[:, None], kp[0], vp[0], bt, kvl,
                                      (kvl - 1)[:, None], block_size=bs, **one)
            if not (torch.equal(dec[:, 0], out) and torch.equal(disp[:, 0], out)):
                fail(f"{name}: paged_attention_decode / paged_attention differ "
                     "from the kernel's output")
            log(f"{name}: paged_attention_decode and paged_attention give the "
                "kernel's output")

    # Cycle through the layers so each launch meets its pages cold in L2,
    # as the decode step does (28 layers apart).
    def kern(i):
        return kernel(q, kp, vp, bt, kvl, i % n_layers, block_size=bs, **sc)

    def plain(i):
        return pa.paged_flash_decode_stats_ref(q, kp, vp, bt, kvl, i % n_layers,
                                               block_size=bs, **sc)

    # Yardstick: SDPA over the same K/V gathered contiguous per layer
    # (int8: dequantized to q's dtype; gather and dequantization not
    # timed), padded to the longest row with a key mask.
    s_max = max(max(kv_lens), 1)
    n_lib = min(4, n_layers)
    wins = []
    slots = (bt.long()[:, :, None] * bs
             + torch.arange(bs, device=device)).reshape(b, -1)[:, :s_max]
    for layer in range(n_lib):
        win = []
        for pool, scale in ((kp, ks), (vp, vs)):
            w = torch.stack([pool[layer][:, slots[i]] for i in range(b)])
            if quant:
                w = dequantize_kv(w, torch.stack(
                    [scale[layer][:, slots[i]] for i in range(b)]), dtype)
            win.append(w.contiguous())                     # [B, Hkv, S, Dh]
        wins.append(win)
    mask = (torch.arange(s_max, device=device)[None, :] < kvl[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa(i):
        kw, vw = wins[i % n_lib]
        return F.scaled_dot_product_attention(q4, kw, vw, attn_mask=mask,
                                              enable_gqa=True)

    label = case_label(dname, quant)
    what = f"{name} [{label}]"
    n_calls = 2 * n_layers
    with SmMhz() as clock:
        found = device_profile(torch, kern, n_calls, f"{what} kernel",
                               per_call=1)
    if found is None:
        # CUPTI lost every trace: one launch per call is read from the
        # wrapper's own counter (and graph_check's one node per call),
        # the time by CUDA events.
        pa.reset_launch_counts()
        for i in range(n_calls):
            kern(i)
        torch.cuda.synchronize()
        launched = sum(pa.launch_counts().values())
        if launched != n_calls:
            fail(f"{what}: {launched} launches counted for {n_calls} calls; "
                 "the kernel is one launch per call")
        (ms, ms_by), ms_by_kernel, per_call = (
            events_ms(torch, kern, n_calls, f"{what} kernel"), {}, None)
    else:
        ms, ms_by_kernel, per_call = found
        ms_by = "torch.profiler"
        if len(ms_by_kernel) != 1 or not 0 < per_call <= 1:
            fail(f"{what}: {per_call} device kernels per call "
                 f"({sorted(ms_by_kernel)}); the kernel is one launch per call")
        # CUPTI may drop a record (per_call < 1): the mean recorded launch
        # (read again below).
        ms /= per_call
        ms_by_kernel = {k: v / per_call for k, v in ms_by_kernel.items()}
    plain_ms, _ = device_ms(torch, plain, min(8, n_layers), f"{what} plain")
    library_ms, library_by = events_ms(torch, sdpa, 4 * n_lib, f"{what} SDPA")
    bound_ms, bound_by = bound_of(kv_lens, b, h, hkv, dh, bs, quant,
                                  dtype.itemsize)
    # No reading can beat the bound, and a trace that lost records is no
    # reading either (one launch recorded of 8 has read 1.7x the events'
    # time): both are read again by CUDA events around replayed graphs of
    # the calls.
    if ms < bound_ms or (per_call is not None and per_call < 1):
        log(f"{what}: profiler reading {ms:.5f} ms ({per_call} launches "
            f"recorded per call; bound {bound_ms:.5f} ms); timing by CUDA events")
        ms, ms_by = events_ms(torch, kern, 2 * n_layers, f"{what} kernel")
    events = {}
    if name.startswith("main path"):
        # The main path's two times read a second way, by CUDA events, and
        # the two single-layer wrappers' (each one launch of the kernel).
        one = ((lambda i: dict(k_scale=ks[i % n_layers], v_scale=vs[i % n_layers]))
               if quant else (lambda i: {}))

        def wrap_decode(i):
            return pa.paged_attention_decode(
                q[:, None], kp[i % n_layers], vp[i % n_layers], bt, kvl,
                block_size=bs, **one(i))

        def wrap_dispatch(i):
            return pa.paged_attention(
                q[:, None], kp[i % n_layers], vp[i % n_layers], bt, kvl,
                (kvl - 1)[:, None], block_size=bs, **one(i))

        events = {"ms_events": events_ms(torch, kern, 2 * n_layers,
                                         f"{what} kernel")[0],
                  "paged_attention_decode_ms": events_ms(
                      torch, wrap_decode, 2 * n_layers, f"{what} decode wrapper")[0],
                  "paged_attention_ms": events_ms(
                      torch, wrap_dispatch, 2 * n_layers, f"{what} dispatch wrapper")[0]}
    del q, kp, vp, ks, vs, bt, kvl, wins, sc
    torch.cuda.empty_cache()
    row = {"case": name, "variant": label,
           "kernel": pa.variant_of(dtype, quant, dh, h // hkv, bs), "dtype": dname,
           "block_size": bs, "B": b, "H": h, "Hkv": hkv, "Dh": dh,
           "kv_tokens": sum(kv_lens),
           "max_kv_len": max(kv_lens), "max_abs_err": max_err,
           "max_row_rel_err": max_row_rel, "control_row_rel_err": controls,
           "ms": ms, "ms_by": ms_by, "ms_by_kernel": ms_by_kernel,
           "recorded_per_call": per_call, "library_by": library_by, **events,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms, "library_ms": library_ms,
           "vs_library": ms / library_ms, "sm_clock_mhz": clock.summary()}
    log(f"kernel case {json.dumps(row)}")
    return row


def kernel_phase(torch, pa, device, seed, main_lens):
    rng = random.Random(seed)
    cases = []
    for (h, hkv, dh, n_layers, label) in ((24, 8, 128, 28, "llama-3b heads"),
                                          (32, 4, 64, 22, "llama-1b heads")):
        for b in (1, 8, 32):
            lens = [0, 1, 17, 4001][:b] if b > 1 else [4001]
            lens = lens + [rng.randint(1, 4096) for _ in range(b - len(lens))]
            cases.append((f"{label} B={b}", b, h, hkv, dh, lens, n_layers))
    # The main path's shape: the served batch mid-decode.
    cases.append(("main path llama-3b B=4", 4, 24, 8, 128, main_lens, 28))
    rows = [run_kernel_case(torch, pa, *c, seed=seed + i, device=device,
                            quant=quant)
            for quant in (False, True) for i, c in enumerate(cases)]
    # The Pallas kernel's domain past the served shape, at llama-3b's width
    # (float32, float16 and bf16 at its heads, head dim 256, 24 query heads
    # per kv head, one-token pages in bf16 and float16 and at head dim 256;
    # the bf16 case reads the bytes of the f16, Dh 256 and block-size-1
    # cases) and head dim 32 at tiny-llama-8kv's heads, B = 8 of ragged
    # lengths, 4 layers; the domain phase's main paths (llama-3b in float32
    # and float16, tiny-llama in bf16 and float16) at the served batch's
    # lengths; and the generic kernel's bf16 and f16 at head dim 16 (no
    # model's: off the main path). Each over compute-dtype and int8 pools.
    lens = [0, 1, 17, 4001] + [rng.randint(1, 4096) for _ in range(4)]
    f32, f16, bf16 = torch.float32, torch.float16, torch.bfloat16
    domain = [("f32 llama-3b heads B=8", 8, 24, 8, 128, lens, f32, 16),
              ("f16 llama-3b heads B=8", 8, 24, 8, 128, lens, f16, 16),
              ("bf16 llama-3b heads B=8", 8, 24, 8, 128, lens, bf16, 16),
              ("Dh 256 H=12 Hkv=4 B=8", 8, 12, 4, 256, lens, bf16, 16),
              ("G 24 H=24 Hkv=1 B=8", 8, 24, 1, 128, lens, bf16, 16),
              ("block size 1 llama-3b heads B=8", 8, 24, 8, 128, lens, bf16, 1),
              ("f16 block size 1 llama-3b heads B=8", 8, 24, 8, 128, lens, f16, 1),
              ("block size 1 Dh 256 H=12 Hkv=4 B=8", 8, 12, 4, 256, lens, bf16, 1),
              ("Dh 32 tiny-llama-8kv heads B=8", 8, 8, 8, 32, lens, bf16, 16),
              ("main path llama-3b f32 B=4", 4, 24, 8, 128, main_lens, f32, 16),
              ("main path llama-3b f16 B=4", 4, 24, 8, 128, main_lens, f16, 16),
              ("main path tiny-llama B=4", 4, 4, 2, 32, main_lens, bf16, 16),
              ("main path tiny-llama f16 B=4", 4, 4, 2, 32, main_lens, f16, 16),
              ("Dh 16 H=4 Hkv=2 B=4", 4, 4, 2, 16, main_lens, bf16, 16),
              ("f16 Dh 16 H=4 Hkv=2 B=4", 4, 4, 2, 16, main_lens, f16, 16)]
    for i, (name, b, h, hkv, dh, case_lens, dtype, bs) in enumerate(domain):
        for quant in (False, True):
            rows.append(run_kernel_case(
                torch, pa, name, b, h, hkv, dh, case_lens, 4,
                seed=seed + 100 + i, device=device, quant=quant, bs=bs,
                dtype=dtype))
    return rows


# ---------------------------------------------------------------- domain
DOMAIN_TOKENS = 32                  # tokens per stream
# (model, compute dtype, kv_cache_dtype): "bfloat16" pools hold the
# compute dtype. Each run's variant of the paged kernels: the generic
# kernel's float32 ones at llama-3b, the tensor-core kernel's bf16 ones at
# tiny-llama's head dim 32 and its float16 ones at llama-3b's width.
DOMAIN_RUNS = (("llama-3b", "float32", "bfloat16"), ("llama-3b", "float32", "int8"),
               ("tiny-llama", "bfloat16", "bfloat16"), ("tiny-llama", "bfloat16", "int8"),
               ("llama-3b", "float16", "bfloat16"), ("llama-3b", "float16", "int8"))


def domain_prompts(seed: int):
    """4 prompts of ~150-400 ByteTokenizer tokens: with DOMAIN_TOKENS more
    they fit tiny-llama's 512 positions."""
    rng = random.Random(seed + 22)
    words = ("every shape the gate admits runs a kernel written for the card "
             "float32 and half precision pages of one token").split()
    out = []
    for i in range(4):
        text = []
        while sum(len(w) + 1 for w in text) < 150 + 80 * i:
            text.append(rng.choice(words))
        out.append(" ".join(text))
    return out


def domain_config(model, dtype, kv, seed, device, **over):
    """One engine of the domain phase: ``model`` (a named config or a cut
    directory, its weights drawn from the seed) in ``dtype`` with ``kv``
    pools, ``attn_impl="paged"``, block 16, 512 tokens per row, 4 rows,
    graphs captured at warm-up."""
    from production_stack_tpu_torch.engine.config import EngineConfig

    return EngineConfig(**{
        "model": model, "dtype": dtype, "kv_cache_dtype": kv, "attn_impl": "paged",
        "device": device, "seed": seed, "load_format": "dummy",
        "max_model_len": 512, "block_size": 16, "num_kv_blocks": 4 * 512 // 16 + 1,
        "max_num_seqs": 4, "num_decode_steps": 32,
        "max_num_batched_tokens": WARM_PREFILL_BUDGET, "enable_warmup": True, **over})


def engine_variant(pa, engine) -> str:
    """The paged-kernel variant ``engine``'s decode launches (its dtype,
    pool kind, head dim, query heads per kv head and block size)."""
    cfg, mc = engine.config, engine.model_config
    return pa.variant_of(cfg.dtype, cfg.kv_cache_quantized, mc.head_dim_,
                         mc.q_per_kv, cfg.block_size)


def domain_http_round(torch, pa, engine, gate, prompts, what):
    """The 4 streams (``SPEC_SAMPLINGS``: 2 greedy, 2 seeded) x
    DOMAIN_TOKENS behind the port's server, cold (the prefix cache emptied)
    and held until all 4 wait (one prefill batch). Checks every stream's
    length, no eager decode dispatch after warm-up, and the kernels' own
    counts: the engine's variant layers x decode steps, every other 0.
    Returns (token ids per stream, a row of numbers)."""
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    r = engine.runner
    out = {}

    async def run():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        engine.block_manager.reset_prefix_cache()
        steps0 = r.decode_steps_total
        train = r.decode_train
        eager0, graph0 = train.eager_dispatches_total, train.graph_dispatches_total
        pa.reset_launch_counts()
        gate["want"] = 4
        t0 = time.monotonic()

        def one(i):
            body = {"model": engine.config.model_name, "prompt": prompts[i],
                    "max_tokens": DOMAIN_TOKENS, "stream": True, "ignore_eos": True,
                    **SPEC_SAMPLINGS[i]}
            st, evs, _, _ = http("POST", base + "/v1/completions", body, True,
                                 headers={"x-pstpu-resume": "1"})
            if st != 200 or evs[-1] != "[DONE]":
                fail(f"domain {what}: request {i}: HTTP {st}")
            return [t for e in evs[:-1] for t in e.get("pstpu", {}).get("toks", [])]

        toks = await asyncio.gather(*[loop.run_in_executor(None, one, i)
                                      for i in range(4)])
        out.update(toks=toks, wall=time.monotonic() - t0, launches=pa.launch_counts(),
                   steps=r.decode_steps_total - steps0,
                   eager=train.eager_dispatches_total - eager0,
                   graph=train.graph_dispatches_total - graph0)
        await server.stop()

    asyncio.run(run())
    toks, steps = out["toks"], out["steps"]
    if any(len(t) != DOMAIN_TOKENS for t in toks):
        fail(f"domain {what}: stream lengths {[len(t) for t in toks]}")
    variant = engine_variant(pa, engine)
    nl = engine.model_config.num_layers
    if r.device.type != "cuda":
        log(f"domain {what}: off the card: the graph and launch checks skipped")
    elif out["eager"] or not out["graph"]:
        fail(f"domain {what}: {out['eager']} eager decode dispatches after "
             f"warm-up ({out['graph']} replayed)")
    elif out["launches"] != {**dict.fromkeys(pa.VARIANTS, 0), variant: nl * steps}:
        fail(f"domain {what}: kernel launches {out['launches']} for {steps} "
             f"decode steps of {nl} layers, want them all of {variant}")
    row = {"variant": variant, "decode_steps": steps,
           "launches": out["launches"][variant], "wall_s": out["wall"]}
    log(f"domain {what}: served {json.dumps(row)}")
    return toks, row


def domain_run(torch, pa, device, seed, model, dtype, kv, prompts, what):
    """One configuration of the domain phase: the paged engine (graphs
    captured) served through the port's server, then on the engine API
    from its graphs and through the strict eager train (its graphs set
    aside; the same loop, so the same batches and dispatch lengths; each
    round cold): tokens bit for bit; then a window-path twin (same weights,
    KV dtype and batches, the strict loop without graphs, logits kept):
    tokens equal up to the first step whose sampler margin is under 2 x
    ``tp_logit_bound``. Returns (the served round's launches, a row)."""
    from production_stack_tpu_torch.engine.engine import ServingEngine

    t0 = time.monotonic()
    engine = ServingEngine(domain_config(model, dtype, kv, seed, device.type))
    mc = engine.model_config
    if engine.runner.attn_impl != "paged":
        fail(f"domain {what}: the engine took the {engine.runner.attn_impl} path")
    gate = gate_schedule(engine)
    served, row = domain_http_round(torch, pa, engine, gate, prompts, what)
    engine.block_manager.reset_prefix_cache()
    graph = spec_api_round(engine, gate, prompts, n_tokens=DOMAIN_TOKENS)
    engine.block_manager.reset_prefix_cache()
    eager = spec_api_round(engine, gate, prompts, eager=True, n_tokens=DOMAIN_TOKENS)
    for name, got in (("the served round's", served), ("the strict eager train's", eager)):
        bad = [i for i in range(4) if got[i] != graph[i]]
        if bad:
            fail(f"domain {what}: graph-replayed tokens differ from {name} on "
                 f"streams {bad}")
    engine.shutdown()
    del engine
    gc.collect()
    twin = ServingEngine(domain_config(
        model, dtype, kv, seed, device.type, attn_impl="window", enable_warmup=False,
        async_pipeline=False, overlap_dispatch=False))
    tgate = gate_schedule(twin)
    sink = []
    want = spec_api_round(twin, tgate, prompts, eager=True, sink=sink,
                          n_tokens=DOMAIN_TOKENS)
    margins = [[sampler_margin(torch, sink[t][i].float(), SPEC_SAMPLINGS[i], t)
                for t in range(DOMAIN_TOKENS)] for i in range(4)]
    twin.shutdown()
    del twin, sink
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    bound = tp_logit_bound(mc.num_layers, mc.vocab_size * DOMAIN_TOKENS * 4)
    firsts, ok = spec_token_bar(graph, want, margins, 2 * bound)
    if not ok:
        fail(f"domain {what}: paged tokens part from the window twin's where "
             f"its margin exceeds 2 x {bound}: {firsts}")
    row.update(first_divergence=firsts, bound=bound, seconds=time.monotonic() - t0,
               graph_equal_eager=True)
    log(f"domain {what}: {json.dumps(row)}")
    return row["launches"], row


def domain_phase(torch, pa, device, seed, cut_dirs):
    """The ``domain`` phase: every DOMAIN_RUNS configuration (llama-3b at
    full width cut to ``CUT_LAYERS``, tiny-llama whole) through
    ``domain_run``. Returns ({variant: the served rounds' launches}, a
    summary)."""
    prompts = domain_prompts(seed)
    launches, out = {}, {}
    for model, dtype, kv in DOMAIN_RUNS:
        what = f"{model} {dtype} [{kv} KV]"
        path = model if model.startswith("tiny") else cut_model(
            torch, device, seed, model, cut_dirs)
        n, row = domain_run(torch, pa, device, seed, path, dtype, kv, prompts, what)
        launches[row["variant"]] = launches.get(row["variant"], 0) + n
        out[what] = {k: row[k] for k in ("variant", "decode_steps", "launches",
                                         "first_divergence", "bound", "seconds")}
    return launches, out


# ---------------------------------------------------------------- phase 4
def http(method, url, body=None, stream=False, timeout=600, headers=None):
    """(status, parsed JSON or list of SSE payloads, t_first_event, t_end)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not stream:
            return resp.status, json.loads(resp.read()), None, time.monotonic()
        events, t_first = [], None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if t_first is None:
                t_first = time.monotonic()
            payload = line[len("data: "):]
            events.append(payload if payload == "[DONE]" else json.loads(payload))
        return resp.status, events, t_first, time.monotonic()


def make_prompts(seed: int, n: int):
    rng = random.Random(seed)
    words = ("the quick brown fox jumps over a lazy dog while serving "
             "paged attention kernels on one card keeps every stream busy "
             "tokens flow through the scheduler into the runner").split()
    out = []
    for i in range(n):
        target = 1000 + 250 * i            # ~1-2 kB of ByteTokenizer tokens
        text = []
        while sum(len(w) + 1 for w in text) < target:
            text.append(rng.choice(words))
        out.append(" ".join(text))
    return out


# Kernel classes of the trace breakdown, by CUDA kernel name (first match).
KERNEL_CLASSES = (
    ("paged decode kernel", ("paged_decode",)),
    ("bf16 GEMM", ("nvjet", "bf16gemm", "s16816gemm", "bf16_s1688gemm")),
    ("f32 GEMM / GEMV", ("sgemm", "gemm_f32", "xmma_gemm_f32", "gemmSN", "gemv")),
    ("copy / cast", ("copy", "Copy", "cast")),
    ("index / gather / scatter", ("index", "gather", "scatter")),
    ("reduction", ("reduce", "Reduce", "softmax", "cumsum", "scan", "topk",
                   "sort", "radix", "argmax")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def trace_requests(torch, loop_run, n_tokens):
    """Profile one served round (4 fresh short prompts, one padded prefill
    and the fused decode dispatches of the same 4 rows, replayed from
    graphs): host wall time, device busy time (sum of kernel times on the
    one stream), the kernels that take it, and their classes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        loop_run(n_tokens)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name = {}
    count = paged_records = 0
    for evt in prof.events():
        if str(evt.device_type).endswith("CUDA"):
            count += 1
            paged_records += "paged_decode" in evt.name
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    by_class = {}
    for name, us in by_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if wall else None, "kernel_launches": count,
            "paged_decode_records": paged_records,
            "ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "top_ms": [[name[:100], us / 1e3] for name, us in top]}


def serving_config(seed, kv_cache_dtype, device="cuda", model="llama-3b"):
    """The serving phase's engine config: the server's defaults (decode and
    prefill graphs captured at warm-up, the weights filled on a background
    thread beside it, the pipelined two-slot loop, the KV pool sized from
    free memory, less the prefill graphs' reserve), with the elastic
    phase's manifest directory: the serving phase's start is cold and
    writes the manifest, the elastic phase's second start of the same
    config finds it."""
    from production_stack_tpu_torch.engine.config import EngineConfig

    return EngineConfig(model=model, dtype="bfloat16", attn_impl="paged",
                        device=device, max_model_len=4096, num_decode_steps=32,
                        seed=seed, enable_warmup=True, kv_cache_dtype=kv_cache_dtype,
                        overlap_weight_load=True,
                        compilation_cache_dir=ELASTIC_CACHE)


def serving_phase(torch, pa, device, seed, prompts, card, kv_cache_dtype,
                  trace=False, keep=False, model="llama-3b"):
    """Serve llama-3b (``model``: the name at full depth, or a ``cut_model``
    directory) over HTTP with a KV pool of ``kv_cache_dtype``.
    Returns the launch counts of this run's main path, the summary, and
    the engine (stopped, still warm) when ``keep``, else None."""
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    max_tokens = 64
    cfg = serving_config(seed, kv_cache_dtype, model=model)
    variant = pa.INT8 if cfg.kv_cache_quantized else pa.BF16
    t0 = time.monotonic()
    engine = ServingEngine(cfg)
    torch.cuda.synchronize()
    log(f"serving [{kv_cache_dtype} KV]: llama-3b engine up in "
        f"{time.monotonic() - t0:.3f} s ({engine.model_config.num_layers} "
        f"layers, random bf16 weights, "
        f"{engine.runner.num_kv_blocks} KV blocks, "
        f"kv_pool_bytes {engine.runner.kv_pool_bytes}, "
        f"attn={engine.runner.attn_impl}, "
        f"weights+pool {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    results = {}

    async def run():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        reqs = [
            ("completion greedy", "/v1/completions", False,
             {"prompt": prompts[0], "max_tokens": max_tokens,
              "temperature": 0.0, "ignore_eos": True}),
            ("completion seeded", "/v1/completions", False,
             {"prompt": prompts[1], "max_tokens": max_tokens,
              "temperature": 0.8, "top_p": 0.9, "seed": 1234,
              "ignore_eos": True}),
            ("chat stream greedy", "/v1/chat/completions", True,
             {"messages": [{"role": "user", "content": prompts[2]}],
              "max_tokens": max_tokens, "temperature": 0.0, "stream": True,
              "stream_options": {"include_usage": True}, "ignore_eos": True}),
            ("chat stream seeded", "/v1/chat/completions", True,
             {"messages": [{"role": "user", "content": prompts[3]}],
              "max_tokens": max_tokens, "temperature": 0.7, "top_k": 50,
              "seed": 7, "stream": True,
              "stream_options": {"include_usage": True}, "ignore_eos": True}),
        ]
        st, body, _, _ = await loop.run_in_executor(
            None, http, "GET", base + "/health")
        if st != 200 or body.get("status") != "healthy":
            fail(f"/health: {st} {body}")
        st, body, _, _ = await loop.run_in_executor(
            None, http, "GET", base + "/v1/models")
        if st != 200 or body["data"][0]["id"] != cfg.model_name:
            fail(f"/v1/models: {st} {body}")
        # One short untimed request first: a served engine is warm (cuBLAS
        # handles, allocator pools, the kernel library's first load).
        st, body, _, _ = await loop.run_in_executor(
            None, http, "POST", base + "/v1/completions",
            {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0,
             "ignore_eos": True})
        if st != 200 or body["usage"]["completion_tokens"] != 4:
            fail(f"warm-up request: {st} {body}")
        for key in ("decode_steps_total", "decode_tokens_total",
                    "decode_seconds_total", "decode_device_seconds_total",
                    "prefill_seconds_total"):
            setattr(engine.runner, key, 0)
        engine.decode_dispatches_total = engine.prefill_dispatches_total = 0
        engine.runner.decode_train.eager_dispatches_total = 0
        pa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.monotonic()

        def one(name, path, stream, body):
            t = time.monotonic()
            st, out, t_first, t_end = http("POST", base + path, body, stream)
            results[name] = (st, out, t, t_first, t_end)

        with SmMhz() as clock:
            await asyncio.gather(*[loop.run_in_executor(None, one, *r) for r in reqs])
        results["_wall"] = time.monotonic() - t_start
        results["_clock"] = clock.summary()
        results["_launches"] = pa.launch_counts()
        results["_stats"] = engine.stats()
        results["_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # The start's seconds by phase, as the router's scraper reads them.
        st_m, _, text = await loop.run_in_executor(
            None, request, "GET", base + "/metrics")
        if st_m != 200:
            fail(f"serving [{kv_cache_dtype} KV]: /metrics {st_m}")
        results["_startup"] = {
            name[len("pstpu:"):]: vals[0][1]
            for name, vals in parse_metrics(text).items()
            if name.startswith("pstpu:startup_")}
        if trace:
            def round_of(n_tokens):
                # 4 fresh short prompts (one small prefill, no history
                # window), then n_tokens - 1 decode steps in 32-step
                # dispatches: the round is mostly graph replays.
                def go(i):
                    http("POST", base + "/v1/completions", {
                        "prompt": f"trace round prompt {i}: " * 4,
                        "max_tokens": n_tokens,
                        "temperature": 0.0 if i % 2 == 0 else 0.8,
                        "seed": i, "ignore_eos": True})
                threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()

            steps0 = engine.runner.decode_steps_total
            pa.reset_launch_counts()
            tr = await loop.run_in_executor(
                None, trace_requests, torch, round_of, 65)
            tr["decode_steps"] = engine.runner.decode_steps_total - steps0
            # Two witnesses of the kernel's launches in the traced round:
            # its device counter, and the profiler's records of it (CUPTI
            # may drop a few records, never add one).
            tr["paged_decode_counted"] = pa.launch_counts()[pa.BF16]
            log(f"trace {json.dumps(tr)}")
            if not 0 < tr["paged_decode_records"] <= tr["paged_decode_counted"]:
                fail(f"trace: {tr['paged_decode_records']} profiler records of the "
                     f"paged kernel against {tr['paged_decode_counted']} counted "
                     "launches")
        await server.stop()

    asyncio.run(run())
    if not keep:
        engine.shutdown()
        engine = None
    stats = results["_stats"]
    ttfts = []
    for name in ("completion greedy", "completion seeded",
                 "chat stream greedy", "chat stream seeded"):
        st, out, t0_, t_first, t_end = results[name]
        if st != 200:
            fail(f"{name}: HTTP {st}")
        if isinstance(out, list):
            if out[-1] != "[DONE]":
                fail(f"{name}: stream did not end in [DONE]")
            usage = [e for e in out[:-1] if e.get("usage")]
            if not usage:
                fail(f"{name}: no usage chunk")
            n_out = usage[-1]["usage"]["completion_tokens"]
            finish = [c["finish_reason"] for e in out[:-1]
                      for c in e["choices"] if c.get("finish_reason")]
            ttfts.append(t_first - t0_)
        else:
            n_out = out["usage"]["completion_tokens"]
            finish = [out["choices"][0]["finish_reason"]]
        if n_out != max_tokens or finish != ["length"]:
            fail(f"{name}: {n_out} tokens (want {max_tokens}), finish {finish}")
        log(f"serving [{kv_cache_dtype} KV]: {name}: HTTP 200, {n_out} tokens, "
            f"finish=length, {t_end - t0_:.3f} s")
    steps = stats["decode_steps_total"]
    counts = results["_launches"]
    launches = counts[variant]
    n_layers = engine.model_config.num_layers
    if steps <= 0 or launches != n_layers * steps:
        fail(f"{variant} launches {launches} != {n_layers} layers x {steps} "
             "decode steps: decode did not go through the kernel once per "
             "layer and step")
    others = {k: v for k, v in counts.items() if k != variant and v}
    if others:
        fail(f"{kv_cache_dtype} KV run launched another variant: {others}")
    if stats["decode_eager_dispatches_total"] or not stats["graph_families"]:
        fail(f"serving [{kv_cache_dtype} KV]: {stats['decode_eager_dispatches_total']} "
             f"eager decode dispatches, {stats['graph_families']} graph families: "
             "decode did not replay its warm-up graphs")
    log(f"serving [{kv_cache_dtype} KV]: {launches} {variant} launches counted "
        f"by the kernel over {steps} decode steps "
        f"({stats['decode_dispatches_total']} decode dispatches, all graph "
        f"replays; {stats['prefill_dispatches_total']} prefill dispatches)")
    summary = {
        "card": card, "kv_cache_dtype": kv_cache_dtype,
        "kv_blocks": stats["kv_num_blocks"],
        "kv_pool_bytes": stats["kv_pool_bytes"], "wall_s": results["_wall"],
        "ttft_s_streamed": ttfts,
        "prefill_s_total": stats["prefill_seconds_total"],
        "decode_tokens": stats["decode_tokens_total"],
        "decode_device_s_total": stats["decode_device_seconds_total"],
        "decode_ms_per_step_events": (
            1e3 * stats["decode_device_seconds_total"] / steps),
        "aggregate_tok_s": 4 * max_tokens / results["_wall"],
        "dispatch_overlap_ratio": stats["dispatch_overlap_ratio"],
        "graphs": {k: stats[k] for k in (
            "graph_families", "graphs_captured", "graph_step_nodes_max",
            "graph_capture_seconds", "graph_pool_bytes")},
        "peak_mem_gib": results["_peak_gib"],
        "launches": counts, "decode_steps": steps,
        "sm_clock_mhz": results["_clock"],
        # /metrics' startup gauges, and the phases stats() splits them into
        "startup": results["_startup"],
        "startup_phase_seconds": stats["startup_phase_seconds"],
    }
    log(f"serving result {json.dumps(summary)}")
    return counts, summary, engine


# ---------------------------------------------------------------- phase 5
def step_bound_ms(mc, kv_lens, quant):
    """Least time of one decode step at B = len(kv_lens): the bytes it must
    move at the card's HBM rate (the bf16 layer weights and the bf16 output
    head read once, each row's live KV read once, bf16 2 B or int8 1 B an
    element plus the 2-byte scale per slot and head); the step's 2 * params
    * B operations take far less at the bf16 peak. The port reads an f32
    copy of the head (to match the JAX package's bf16 x bf16 -> f32 dot):
    ``f32_head_extra_ms`` is that design's extra read, not in the bound."""
    d, f, dh = mc.hidden_size, mc.intermediate_size, mc.head_dim_
    h, hkv = mc.num_heads, mc.num_kv_heads
    layer = d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * f + 2 * d
    weight_bytes = (mc.num_layers * layer + d * mc.vocab_size) * 2
    kv_bytes = sum(kv_lens) * 2 * mc.num_layers * hkv * (dh + 2 if quant else 2 * dh)
    ops = 2 * (mc.num_layers * layer + d * mc.vocab_size) * len(kv_lens)
    return max((weight_bytes + kv_bytes) / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S) * 1e3


def f32_head_extra_ms(mc):
    """The extra read of the port's f32 output head over a bf16 one, at
    the card's HBM rate."""
    return mc.hidden_size * mc.vocab_size * 2 / HBM_BYTES_PER_S * 1e3


def graph_prompts(seed: int):
    """4 prompts of 500-950 bytes: one prefill dispatch holds all four
    (fair share 1024 tokens each), so the strict and the pipelined loop form
    the same batches and their tokens can be compared bit for bit."""
    rng = random.Random(seed + 1)
    words = "graphs replay the decode train of every family we warmed".split()
    out = []
    for i in range(4):
        text = []
        while sum(len(w) + 1 for w in text) < 500 + 150 * i:
            text.append(rng.choice(words))
        out.append(" ".join(text))
    return out


def graphs_phase(torch, pa, device, seed, card, kv, engine=None,
                 model="llama-3b"):
    """With a ``kv`` pool: the strict eager loop (no warm-up graphs, no
    pipeline) and the graph + pipeline + overlap loop serve the same 4
    requests (2 greedy, 2 seeded, 64 tokens), alternated eager, graph,
    graph, eager in this one call, on two engines: an eager one on the same
    weights, and the graph one, the serving phase's warm ``engine`` (or one
    of its config, warmed at its first start), restarted for each graph run
    (its graphs stay valid). Its KV pool is sized from free memory, so the
    prefill graphs' reserve is what keeps its capture from running out of
    memory. Each graph run
    logs its warm-up (families, graphs, nodes, capture seconds, graph pool,
    decode and prefill); it must give the eager tokens bit for bit, make no
    eager decode or prefill dispatch, launch its kernel variant once per
    layer and decode step (the kernel's own count) and the other variant
    never. The first graph run then serves a round whose prefill lands
    mid-decode (its fetches must overlap) and the prefill part
    (``prefill_part``) runs on its engine. Returns (one summary row per
    run, the prefill part's row); shuts both engines down."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import resolve_model_config

    mc = resolve_model_config(model)
    if engine is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = llama.init_params(mc, gen, torch.bfloat16, device)
        engine = ServingEngine(serving_config(seed, kv, device.type, model),
                               params=params)
    params = engine.runner.params
    prompts = graph_prompts(seed)
    samplings = [dict(temperature=0.0), dict(temperature=0.0),
                 dict(temperature=0.8, top_p=0.9, seed=1234),
                 dict(temperature=0.7, top_k=50, seed=7)]
    max_tokens = 64
    modes = {"eager": dict(enable_warmup=False, async_pipeline=False,
                           overlap_dispatch=False),
             "graph": dict(enable_warmup=True, async_pipeline=True,
                           overlap_dispatch=True)}
    rows, prefill_row = [], None
    quant = kv == "int8"
    variant, other = (pa.INT8, pa.BF16) if quant else (pa.BF16, pa.INT8)
    tokens = {}
    common = dict(model=model, dtype="bfloat16", attn_impl="paged",
                  device=device.type, max_model_len=4096, num_decode_steps=32,
                  seed=seed, kv_cache_dtype=kv)
    engines = {
        "eager": ServingEngine(EngineConfig(
            **common, num_kv_blocks=(2 if quant else 1) * BF16_KV_BLOCKS,
            **modes["eager"]), params=params),
        "graph": engine}
    for i, mode in enumerate(("eager", "graph", "graph", "eager")):
        engine = engines[mode]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {}

        async def one(k, prompt, extra, n=max_tokens):
            t_sub, t_first, toks = time.monotonic(), None, []
            async for out in engine.generate(prompt=prompt, sampling=SamplingParams(
                    max_tokens=n, ignore_eos=True, **extra)):
                if t_first is None and out.token_ids:
                    t_first = time.monotonic()
                toks = out.token_ids
            times[k] = (t_sub, t_first, time.monotonic())
            return toks

        async def serve():
            t_warm = time.monotonic()
            await engine.start()
            warm_s = time.monotonic() - t_warm
            engine.block_manager.reset_prefix_cache()
            # One short untimed request first (cuBLAS handles, the
            # prefill shapes' first use), as the serving phase does.
            await one("warm-up", "warm up", dict(temperature=0.0), 4)
            pa.reset_launch_counts()
            r = engine.runner
            r.decode_steps_total = r.decode_tokens_total = 0
            r.decode_device_seconds_total = 0.0
            r.chained_dispatches_total = 0
            r.decode_train.eager_dispatches_total = 0
            r.prefill_train.eager_dispatches_total = 0
            r.prefill_train.graph_dispatches_total = 0
            engine.decode_dispatches_total = 0
            # The 4 requests are created together: they are all queued
            # before the engine loop schedules again, so every loop
            # mode forms the same batches.
            t0 = time.monotonic()
            tasks = [asyncio.create_task(one(k, p, samplings[k]))
                     for k, p in enumerate(prompts)]
            with SmMhz() as clock:
                got = await asyncio.wait_for(asyncio.gather(*tasks), 600)
            wall = time.monotonic() - t0
            times["_clock"] = clock.summary()
            launches = pa.launch_counts()
            stats = engine.stats()
            overlap = None
            if mode == "graph" and i == 1:
                overlap = await overlap_round()
            await engine.stop()
            return got, wall, warm_s, t0, launches, stats, overlap

        async def wait_until(cond):
            deadline = time.monotonic() + 120
            while not cond():
                if time.monotonic() > deadline:
                    fail("graphs: the overlap round made no progress")
                await asyncio.sleep(0.001)

        async def overlap_round():
            """A decode stream, then a prompt landing mid-decode."""
            engine.fetches_total = engine.overlapped_fetches_total = 0
            d0 = engine.decode_dispatches_total
            long = asyncio.create_task(one("long", prompts[0] + " again",
                                           dict(temperature=0.0)))
            await wait_until(lambda: engine.decode_dispatches_total >= d0 + 2)
            late = asyncio.create_task(one("late", prompts[1] + " late",
                                           dict(temperature=0.8, seed=3)))
            await asyncio.wait_for(asyncio.gather(long, late), 300)
            st = engine.stats()
            return {"fetches": st["fetches_total"],
                    "overlapped_fetches": st["overlapped_fetches_total"],
                    "dispatch_overlap_ratio": st["dispatch_overlap_ratio"]}

        got, wall, warm_s, t0, launches, st, overlap = asyncio.run(serve())
        peak = torch.cuda.max_memory_allocated() / 2**30
        name = f"graphs [{kv} KV] run {i + 1} {mode}"
        if any(len(t) != max_tokens for t in got):
            fail(f"{name}: {[len(t) for t in got]} tokens, want {max_tokens}")
        steps = st["decode_steps_total"]
        ttft = [times[k][1] - times[k][0] for k in range(len(prompts))]
        # Client-side wall time per decode step: every row gets one
        # token per step, so a row's first-to-last token time over its
        # tokens after the first.
        wall_step = [(times[k][2] - times[k][1]) / (max_tokens - 1)
                     for k in range(len(prompts))]
        row = {
            "card": card, "kv_cache_dtype": kv, "run": i + 1, "mode": mode,
            "decode_steps": steps,
            "decode_dispatches": st["decode_dispatches_total"],
            "decode_ms_per_step_events": 1e3 * st["decode_device_seconds_total"] / steps,
            "decode_ms_per_step_wall": 1e3 * sum(wall_step) / len(wall_step),
            "ttft_s": ttft, "wall_s": wall,
            "aggregate_tok_s": len(prompts) * max_tokens / wall,
            "peak_mem_gib": peak, "launches": launches,
            "step_bound_ms": step_bound_ms(
                mc, [len(p) + max_tokens // 2 for p in prompts], quant),
            "f32_head_extra_ms": f32_head_extra_ms(mc),
            "decode_eager_dispatches": st["decode_eager_dispatches_total"],
            "prefill_eager_dispatches": st["prefill_eager_dispatches_total"],
            "prefill_graph_dispatches": st["prefill_graph_dispatches_total"],
            "chained_dispatches": st["chained_dispatches_total"],
            "dispatch_overlap_ratio": st["dispatch_overlap_ratio"],
            "kv_blocks": st["kv_num_blocks"],
            "sm_clock_mhz": times["_clock"],
        }
        if mode == "graph":
            row.update(warmup_s=warm_s, overlap_round=overlap,
                       **{k: st[k] for k in (
                           "graph_families", "graphs_captured",
                           "graph_nodes_total", "graph_step_nodes_max",
                           "graph_capture_seconds", "graph_pool_bytes",
                           "graph_families_logprobs",
                           "graph_pool_bytes_logprobs",
                           "prefill_graph_families", "prefill_graph_nodes_max",
                           "prefill_warm_seconds", "prefill_capture_seconds",
                           "graph_pool_bytes_prefill")})
            row["graph_pool_mib"] = st["graph_pool_bytes"] / 2**20
            if st["decode_eager_dispatches_total"]:
                fail(f"{name}: {st['decode_eager_dispatches_total']} eager "
                     "decode dispatches after warm-up")
            # Every request here is of the default sampling variant.
            if st["prefill_eager_dispatches_total"] or \
                    not st["prefill_graph_dispatches_total"]:
                fail(f"{name}: {st['prefill_eager_dispatches_total']} eager and "
                     f"{st['prefill_graph_dispatches_total']} replayed prefill "
                     "dispatches after warm-up: want every one replayed")
            n_layers = mc.num_layers
            if launches[variant] != n_layers * steps or launches[other]:
                fail(f"{name}: {launches} launches over {steps} decode steps: "
                     f"want {n_layers} x steps of {variant} and none of {other}")
            if overlap is not None and not overlap["dispatch_overlap_ratio"] > 0:
                fail(f"{name}: no fetch overlapped another dispatch in the "
                     f"round with a prefill landing mid-decode ({overlap})")
        if mode in tokens and got != tokens[mode]:
            fail(f"{name}: tokens differ from the earlier {mode} run")
        tokens.setdefault(mode, got)
        if "eager" in tokens and "graph" in tokens and \
                tokens["eager"] != tokens["graph"]:
            diff = [k for k in range(4) if tokens["eager"][k] != tokens["graph"][k]]
            fail(f"{name}: graph + pipeline tokens differ from the strict "
                 f"eager loop's in requests {diff}")
        log(f"graphs run {json.dumps(row)}")
        rows.append(row)
        if mode == "graph" and i == 1:
            prefill_row = prefill_part(torch, engines["graph"], kv, card)
    log(f"graphs [{kv} KV]: the graph + pipeline + overlap loop gives the "
        "strict eager loop's tokens bit for bit (2 greedy, 2 seeded, "
        f"{max_tokens} tokens each)")
    for e in engines.values():
        e.shutdown()
    del engines, engine, e
    gc.collect()
    torch.cuda.empty_cache()
    prefill_row["exact_rows"] = prefill_exact_rows(
        torch, params, common, kv, prefill_row.pop("tokens"))
    log(f"prefill result {json.dumps(prefill_row)}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, prefill_row


# The prefill part of the graphs phase: prompts of ~64 and ~2,048 tokens
# (each long prompt <= 2,048 tokens, so 4 of them take two 1,024-token
# chunks and every row finishes in the second), decode tokens per stream.
PREFILL_SHORT = 64
PREFILL_LONG = 2048
PREFILL_TOKENS = 32


def prefill_prompts(seed: int, n_tokens: int, vocab: int):
    """4 token-id prompts of n_tokens - 1 - 4 i tokens, ids from ``seed``."""
    rng = random.Random(seed * 7919 + n_tokens)
    return [[rng.randrange(3, vocab) for _ in range(n_tokens - 1 - 4 * i)]
            for i in range(4)]


class PrefillGraphsAside:
    """Inside: the engine's prefill graphs set aside (its prefill runs the
    same functions eagerly), when ``eager``. Entered after ``engine.start``
    and left before ``engine.stop``: a start's warm-up would capture them
    again."""

    def __init__(self, engine, eager):
        self.train, self.eager = engine.runner.prefill_train, eager

    def __enter__(self):
        self.saved = self.train.graphs
        if self.eager:
            self.train.graphs = {}

    def __exit__(self, *exc):
        self.train.graphs = self.saved


def prefill_round(engine, prompts, sink=None, n_tokens=PREFILL_TOKENS,
                  eager=False):
    """The 4 prompts on the engine API, created together once the engine
    is up (all are queued before its loop schedules again, so one prefill
    dispatch takes them all); the engine is started and stopped inside the
    round's event loop; ``eager`` sets its prefill graphs aside. Returns
    (each stream's tokens, each stream's TTFT in s)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    async def one(ids, extra):
        t0, t_first, toks = time.monotonic(), None, []
        async for out in engine.generate(prompt_token_ids=ids, sampling=SamplingParams(
                max_tokens=n_tokens, ignore_eos=True, **extra)):
            if t_first is None and out.token_ids:
                t_first = time.monotonic()
            toks = out.token_ids
        return toks, t_first - t0

    async def run():
        await engine.start()
        engine.runner.logits_sink = sink
        try:
            with PrefillGraphsAside(engine, eager):
                tasks = [asyncio.create_task(one(ids, SPEC_SAMPLINGS[i]))
                         for i, ids in enumerate(prompts)]
                return await asyncio.wait_for(asyncio.gather(*tasks), 600)
        finally:
            engine.runner.logits_sink = None
            await engine.stop()

    got = asyncio.run(run())
    return [g[0] for g in got], [g[1] for g in got]


def prefill_landing_gap(torch, engine, short, long_prompt, eager=False):
    """Four streams decode; once two decode dispatches ran, ``long_prompt``
    lands (``eager``: with the prefill graphs set aside). Returns the
    largest gap (s) between the starts of two consecutive decode dispatch
    issues with the landing prompt's prefill issued between them, and the
    prefill issues' host seconds."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    runner = engine.runner
    issue = runner.execute_async
    marks = []

    def recorded(batch):
        t0 = time.monotonic()
        h = issue(batch)
        marks.append((batch.kind, t0, time.monotonic()))
        return h

    async def one(ids, n):
        async for _ in engine.generate(prompt_token_ids=ids, sampling=SamplingParams(
                max_tokens=n, temperature=0.0, ignore_eos=True)):
            pass

    async def run():
        await engine.start()
        with PrefillGraphsAside(engine, eager):
            tasks = [asyncio.create_task(one(ids, 160)) for ids in short]
            deadline = time.monotonic() + 120
            while sum(k == "decode" for k, _, _ in marks) < 2:
                if time.monotonic() > deadline:
                    fail("prefill: the landing round made no decode progress")
                await asyncio.sleep(0.001)
            tasks.append(asyncio.create_task(one(long_prompt, 8)))
            await asyncio.wait_for(asyncio.gather(*tasks), 300)
        await engine.stop()

    runner.execute_async = recorded
    try:
        asyncio.run(run())
    finally:
        runner.execute_async = issue
    gaps, prefill_host = [], []
    last_decode = None
    between = False
    for kind, t0, t1 in marks:
        if kind == "decode":
            if last_decode is not None and between:
                gaps.append(t0 - last_decode)
            last_decode, between = t0, False
        elif last_decode is not None:
            between = True
            prefill_host.append(t1 - t0)
    if not gaps:
        fail("prefill: no prefill landed between two decode dispatches")
    return max(gaps), prefill_host


def prefill_padding_cost(torch, runner, t, reps=3, rounds=2):
    """One 4-row prefill at (t, full_mb, no window) replayed at b = 8 (the
    reference's row family) against b = 4 (one extra graph, captured here
    only), alternated 8, 4, 4, 8 in ``rounds`` rounds: device ms by CUDA
    events; and the host ms of one replay against one eager run of the
    same functions at b = 8."""
    train = runner.prefill_train
    full_mb = max(f[2] for f in runner.reachable_prefill_families())
    keys = {b: (b, t, full_mb, False, False, 0) for b in (8, 4)}
    if keys[8] not in train.graphs:
        fail(f"prefill: family {keys[8]} was not captured at warm-up")
    saved = (train.capture_seconds, train.pool_bytes,
             runner.decode_train.pool_bytes, train.warmed.copy(),
             train.warm_seconds)
    with runner.kv_io_lock:
        train.warm([keys[4]])
        train.capture([keys[4]])
    extra_pool = train.pool_bytes - saved[1]
    train.capture_seconds, train.pool_bytes, runner.decode_train.pool_bytes = saved[:3]
    train.warmed, train.warm_seconds = saved[3:]
    bufs = {b: train.buffers(*k) for b, k in keys.items()}
    for bf in bufs.values():
        train._zero_inputs(bf)
    ms = {8: [], 4: []}
    for _ in range(rounds):
        for b in (8, 4, 4, 8):
            g = train.graphs[keys[b]]
            g.replay()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            for _ in range(reps):
                g.replay()
            end.record()
            end.synchronize()
            ms[b].append(start.elapsed_time(end) / reps)
    host = {}
    for mode in ("replay", "eager"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if mode == "replay":
            train.graphs[keys[8]].replay()
        else:
            train.prefill(bufs[8])
        host[mode] = (time.monotonic() - t0) * 1e3
        torch.cuda.synchronize()
    del train.graphs[keys[4]], train.nodes[keys[4]]
    return {"key_b8": list(keys[8]), "ms_b8": ms[8], "ms_b4": ms[4],
            "pad_ratio": (sum(ms[8]) / len(ms[8])) / (sum(ms[4]) / len(ms[4])),
            "extra_graph_pool_bytes": extra_pool,
            "host_ms_replay": host["replay"], "host_ms_eager": host["eager"]}


def prefill_part(torch, engine, kv, card):
    """Prefill graphs on the graphs phase's graph engine (warm, idle): its
    prefill families, capture seconds, the prefill share of the graph pool
    against the reserve reckoned from the shapes, KV blocks with and
    without the reserve. Then 4 x ~64 and 4 x ~2,048-token prompts,
    alternated eager (graphs set aside: the same functions over the same
    buffers), graph, graph, eager: tokens bit for bit, no eager prefill
    dispatch in a graph round (default variants), TTFT; the largest
    decode-dispatch gap across a landing long prompt, eager and graph; the
    padding cost of 8 rows against 4; peak memory. Returns its row (with
    the graph tokens under "tokens", for ``prefill_exact_rows``)."""
    r = engine.runner
    train = r.prefill_train
    vocab = r.model_config.vocab_size
    seed = engine.config.seed
    torch.cuda.reset_peak_memory_stats()
    row = {"card": card, "kv_cache_dtype": kv}
    prompts = {"short": prefill_prompts(seed, PREFILL_SHORT, vocab),
               "long": prefill_prompts(seed, PREFILL_LONG, vocab)}
    toks = {}
    for size, ps in prompts.items():
        runs, ttft = [], []
        for mode in ("eager", "graph", "graph", "eager"):
            engine.block_manager.reset_prefix_cache()
            e0, g0 = train.eager_dispatches_total, train.graph_dispatches_total
            got, tt = prefill_round(engine, ps, eager=mode == "eager")
            eager = train.eager_dispatches_total - e0
            replayed = train.graph_dispatches_total - g0
            if mode == "graph" and (eager or not replayed):
                fail(f"prefill [{kv} KV] {size}: {eager} eager and {replayed} "
                     "replayed prefill dispatches in a graph round")
            if mode == "eager" and replayed:
                fail(f"prefill [{kv} KV] {size}: {replayed} replays with the "
                     "graphs set aside")
            runs.append(got)
            ttft.append(tt)
        if any(x != runs[0] for x in runs):
            bad = [i for i in range(4) if len({str(x[i]) for x in runs}) > 1]
            fail(f"prefill [{kv} KV] {size}: graph replays differ from the strict "
                 f"eager run of the same functions on streams {bad}")
        if any(len(t) != PREFILL_TOKENS for t in runs[0]):
            fail(f"prefill [{kv} KV] {size}: {[len(t) for t in runs[0]]} tokens")
        toks[size] = runs[0]
        row[f"ttft_s_{size}"] = {m: [sum(ttft[i]) / 4 for i in idx] for m, idx in (
            ("eager", (0, 3)), ("graph", (1, 2)))}
        log(f"prefill [{kv} KV] {size}: eager, graph, graph, eager equal bit for "
            f"bit; TTFT mean {row[f'ttft_s_{size}']}")
    st = engine.stats()
    row.update({k: st[k] for k in (
        "kv_num_blocks", "kv_blocks_without_prefill_graphs", "prefill_reserve_bytes",
        "prefill_graph_families", "prefill_graph_nodes_max", "prefill_warm_seconds",
        "prefill_capture_seconds", "graph_pool_bytes", "graph_pool_bytes_prefill",
        "graph_capture_seconds", "startup_warmup_seconds", "kv_pool_bytes")})
    gap = {}
    for mode in ("eager", "graph", "graph", "eager"):
        engine.block_manager.reset_prefix_cache()
        g, host = prefill_landing_gap(torch, engine, prompts["short"],
                                      prompts["long"][0], eager=mode == "eager")
        gap.setdefault(mode, []).append([g, host])
    row["landing_gap_s"] = {m: [x[0] for x in v] for m, v in gap.items()}
    row["landing_prefill_host_s"] = {m: [x[1] for x in v] for m, v in gap.items()}
    row["padding"] = {t: prefill_padding_cost(torch, r, t) for t in (128, 1024)}
    row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    row["tokens"] = toks
    return row


def prefill_exact_rows(torch, params, common, kv, toks):
    """The exact-row shape (prefill before rows were padded to the
    reference's families): the same 4-prompt rounds on an engine with
    ``max_prefill_seqs`` 4 (4 rows prefilled at b = 4), strict and eager,
    its logits kept: the graph engine's tokens (b = 8) must equal its up to
    the first step whose sampler margin is at most 2 x ``tp_logit_bound``
    (bf16 GEMM bits depend on the row count). Returns each round's first
    divergences and the bound."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.models.config import resolve_model_config

    mc = resolve_model_config(common["model"])
    exact = ServingEngine(EngineConfig(**common, num_kv_blocks=BF16_KV_BLOCKS * (
        2 if kv == "int8" else 1), max_prefill_seqs=4, async_pipeline=False,
        overlap_dispatch=False), params=params)
    bound = tp_logit_bound(mc.num_layers, mc.vocab_size * PREFILL_TOKENS * 4)
    out = {"bound": bound}
    for size, want in toks.items():
        n = PREFILL_SHORT if size == "short" else PREFILL_LONG
        sink = []
        got, _ = prefill_round(exact, prefill_prompts(common["seed"], n, mc.vocab_size),
                               sink=sink)
        margins = [[sampler_margin(torch, sink[t][i].float(), SPEC_SAMPLINGS[i], t)
                    for t in range(PREFILL_TOKENS)] for i in range(4)]
        firsts, ok = spec_token_bar(want, got, margins, 2 * bound)
        out[size] = firsts
        if not ok:
            fail(f"prefill [{kv} KV] {size}: graph tokens (b = 8) part from the "
                 f"exact-row eager engine's (b = 4) where its margin exceeds "
                 f"2 x {bound}: {firsts}")
    exact.shutdown()
    del exact
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graphs_window_check(torch, seed):
    """The other decode options under graphs, on a small model (tiny-llama
    at Dh 128, bf16): the window path (its head gathers the window inside
    the captured graph) with decode_loop="while" (fewer step replays than
    K), over bf16 and int8 pools. The graph + pipeline loop must give the
    strict eager loop's tokens bit for bit and make no eager dispatch."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    # Prompts of at most 64 tokens: one prefill dispatch holds all four, so
    # both loops form the same batches (a row's bf16 GEMM bits depend on
    # the batch's row count on the card).
    prompts = ["window " * 8, "graphs " * 9, "while loop", "seeded " * 7]
    replayed = {}
    samplings = [dict(max_tokens=40), dict(max_tokens=23),
                 dict(max_tokens=40, temperature=0.9, seed=11),
                 dict(max_tokens=31, temperature=0.7, top_k=20, seed=2)]
    for kv in ("bfloat16", "int8"):
        got = {}
        for mode, over in (("eager", dict(async_pipeline=False)),
                           ("graph", dict(enable_warmup=True))):
            engine = ServingEngine(EngineConfig(
                model="tiny-llama-128dh", device="cuda", dtype="bfloat16",
                attn_impl="window", decode_loop="while", max_model_len=512,
                num_kv_blocks=512, max_num_seqs=8, max_num_batched_tokens=256,
                kv_cache_dtype=kv, seed=seed, **over))

            async def one(prompt, extra):
                toks = []
                async for out in engine.generate(prompt=prompt, sampling=SamplingParams(
                        **{"ignore_eos": True, "temperature": 0.0, **extra})):
                    toks = out.token_ids
                return toks

            async def serve():
                tasks = [asyncio.create_task(one(p, s))
                         for p, s in zip(prompts, samplings)]
                await asyncio.sleep(0)
                await engine.start()
                out = await asyncio.wait_for(asyncio.gather(*tasks), 300)
                await engine.stop()
                return out

            got[mode] = asyncio.run(serve())
            st = engine.stats()
            engine.shutdown()
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            if mode == "graph" and (st["decode_eager_dispatches_total"]
                                    or not st["decode_graph_dispatches_total"]):
                fail(f"graphs [window, while, {kv} KV]: "
                     f"{st['decode_eager_dispatches_total']} eager and "
                     f"{st['decode_graph_dispatches_total']} replayed decode dispatches")
        if got["eager"] != got["graph"] or \
                [len(t) for t in got["graph"]] != [40, 23, 40, 31]:
            fail(f"graphs [window, while, {kv} KV]: graph + pipeline tokens differ "
                 "from the strict eager loop's")
        log(f"graphs [window, while, {kv} KV]: tiny-llama-128dh, the graph + pipeline "
            "loop gives the strict eager loop's tokens bit for bit "
            f"({st['decode_graph_dispatches_total']} replayed decode dispatches)")
        replayed[kv] = st["decode_graph_dispatches_total"]
    return {"window_while_tokens_equal": True, "replayed_dispatches": replayed}


# ---------------------------------------------------------------- phase 6
def check_phase(torch, device, seed, quant):
    """One decode step at llama-3b width, depth cut to 2 layers: the paged
    path (kernel + dense ring segment + merge) against the plain window
    path (gathered window + window_attention) on the same pool, bf16 or
    int8 (the window path then dequantizes in its gather)."""
    from dataclasses import replace

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import resolve_model_config
    from production_stack_tpu_torch.ops.attention import gather_window
    from production_stack_tpu_torch.ops.quantization import quantize_kv

    mc = replace(resolve_model_config("llama-3b"), num_layers=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = llama.init_params(mc, gen, torch.bfloat16, device)
    bs, b = 16, 4
    lens = [0, 33, 700, 1500]
    mb = 128
    blocks = torch.randperm(b * mb, generator=gen, device=device) + 1
    bt = blocks.view(b, mb).to(torch.int32).contiguous()
    shape = (mc.num_layers, mc.num_kv_heads, (b * mb + 1) * bs, mc.head_dim_)
    kp = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
    pos = torch.tensor(lens, dtype=torch.int32, device=device)
    toks = torch.randint(0, 256, (b, 1), generator=gen, device=device)
    ones = torch.ones((b,), dtype=torch.int32, device=device)
    h_p, _, _ = llama.forward(params, mc, toks, pos[:, None], ones,
                              paged=(kp, vp, ks, vs, bt, pos, bs))
    wk, wv = gather_window(kp, vp, bt, bs, ks, vs, out_dtype=torch.bfloat16)
    h_w, _, _ = llama.forward(params, mc, toks, pos[:, None], ones, wk, wv, pos)
    head = llama.lm_head_f32(params, mc)
    lg_p = llama.compute_logits(params, mc, h_p[:, 0], head)
    lg_w = llama.compute_logits(params, mc, h_w[:, 0], head)
    if not (torch.isfinite(lg_p).all() and tuple(lg_p.shape) == (b, mc.vocab_size)):
        fail("check: paged-path logits not finite or wrong shape")
    rel = ((h_p.float() - h_w.float()).norm() / h_w.float().norm()).item()
    agree = (lg_p.argmax(-1) == lg_w.argmax(-1)).float().mean().item()
    max_diff = (lg_p - lg_w).abs().max().item()
    log(f"check [{'int8' if quant else 'bf16'} KV]: llama-3b width x2 layers, "
        f"paged (kernel) vs window (plain): "
        f"hidden rel err {rel:.3e}, logits max abs diff "
        f"{max_diff:.3e}, argmax agreement {agree:.2f}")
    # bf16 activations, and the two paths round at different points (two
    # normalized segments merged vs one softmax): ~1e-2 is rounding.
    if rel > 5e-2:
        fail(f"check [{'int8' if quant else 'bf16'} KV]: hidden rel err "
             f"{rel:.3e} > 5e-2")
    return {"hidden_rel_err": rel, "logits_max_abs_diff": max_diff,
            "argmax_agreement": agree}


def check_noise(torch, device):
    """The seeded-sampling noise (jax.random's threefry Gumbel field, as
    the port computes it) is the same bits on the card as on the CPU, where
    the tests hold it to the JAX package's."""
    from production_stack_tpu_torch.engine.sampling import gumbel_noise

    seeds = [0, 1234, 2**32 - 1]
    on_card = gumbel_noise(seeds, 128256, device).cpu()
    on_cpu = gumbel_noise(seeds, 128256, torch.device("cpu"))
    n_diff = int((on_card.view(torch.int32) != on_cpu.view(torch.int32)).sum())
    log(f"check: Gumbel noise [3 x 128256] on the card vs the CPU: "
        f"{n_diff} values differ")
    if n_diff:
        fail(f"check: {n_diff} Gumbel values differ between the card and the CPU")
    return n_diff


# ---------------------------------------------------------------- phase 7
TP_MODEL = "llama-3-8b"
TP = 2
TP_KV_BLOCKS = 4 * 4096 // 16 + 1   # 4 rows x 4096 tokens + the null block
TF_STEPS = 16                       # teacher-forced decode steps
TP_TIMEOUT_S = 300.0
U_BF16 = 2.0 ** -8                  # bf16 unit roundoff


def tp_logit_bound(n_layers: int, n_samples: int, sources: int = 2) -> float:
    """Bound on max |logit(tp=2) - logit(tp=1)| over ``n_samples`` logits
    of the same teacher-forced tokens, from bf16 rounding (fixed before the
    first card run of the tp phase). A bf16 rounding adds a uniform error of
    relative std u / sqrt(3) (u = 2**-8). tp = 2 rounds each row-parallel
    partial sum (``wo``, ``w_down``) to bf16 before the float32 sum; that
    first extra rounding decorrelates every later rounding of the two runs,
    so they differ like two independent bf16 evaluations of the residual
    stream: one rounding per residual add, 2 L adds, relative to the final
    normalized hidden. The random head's logits have unit std, so a
    relative hidden error e is a logit error of std e: per source
    sigma = sqrt(2) u / sqrt(3) sqrt(2 L). ``sources`` counts independent
    sources of that size: on the card a second one, the summation orders
    of GEMMs and of the paged kernel that depend on the shapes (a rank's
    matrices are half as wide). The max of n Gaussian samples is about
    sqrt(2 ln n) sigma; times 1.5 for the int8 pool's requantization and
    the crudeness of the model. ``tests/test_torch_parallel.py`` holds the
    one-source bound over a 32-layer proxy on the CPU."""
    sigma = math.sqrt(2 * sources) * U_BF16 / math.sqrt(3) * math.sqrt(2 * n_layers)
    return 1.5 * math.sqrt(2 * math.log(n_samples)) * sigma


def tp_kernel_rank(torch, pa, mesh, seed, lens, quant):
    """Every rank of ``mesh`` (one tp group): its slice of a
    main-path-shaped case at llama-3-8b's heads (H 32, Hkv 8, Dh 128, 32
    layers; B 4) through
    ``paged_flash_decode_stats_tp`` against the plain twin on the same
    slice (layers 0 and 31, the kernel phase's tolerances); the slices'
    outputs gathered over the ranks against the one-process kernel over all
    heads (max |diff|, reported). Returns every rank's result (rank 0)."""
    b, h, hkv, dh, n_layers, bs = 4, 32, 8, 128, 32, 16
    group = mesh.tp
    q, kp, vp, ks, vs, bt, kvl = make_case(torch, b, h, hkv, dh, lens, n_layers,
                                           bs, seed, group.device, quant)
    r, tp = group.rank, group.size
    hq, hk = h // tp, hkv // tp

    def mine(t, n):
        return None if t is None else t[:, r * n:(r + 1) * n].contiguous()

    ql, kl, vl = mine(q, hq), mine(kp, hk), mine(vp, hk)
    sc_l = dict(k_scale=mine(ks, hk), v_scale=mine(vs, hk))
    res = {"rank": r, "ok": True, "max_abs_err": 0.0, "max_row_rel_err": 0.0,
           "vs_one_process": 0.0, "H": hq, "Hkv": hk}
    for layer in (0, n_layers - 1):
        out, m, l = pa.paged_flash_decode_stats_tp(ql, kl, vl, bt, kvl, layer,
                                                   block_size=bs, **sc_l)
        ro, rm, rl = pa.paged_flash_decode_stats_ref(ql, kl, vl, bt, kvl, layer,
                                                     block_size=bs, **sc_l)
        if group.device.type == "cuda":
            torch.cuda.synchronize()
        live = kvl > 0
        err, row_rel, ok = out_error(torch, out, ro, live)
        ok = (ok and stats_close(torch, m[live], rm[live])
              and stats_close(torch, l[live], rl[live])
              and all(bool(torch.isfinite(t[live]).all()) for t in (out, m, l)))
        res["ok"] = res["ok"] and ok
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_row_rel_err"] = max(res["max_row_rel_err"], row_rel)
        full = group.all_gather(out, dim=1)
        if r == 0:
            one = pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, layer,
                                              block_size=bs, k_scale=ks, v_scale=vs)[0]
            res["vs_one_process"] = max(res["vs_one_process"],
                                        (full.float() - one.float()).abs().max().item())
    del q, kp, vp, ks, vs, ql, kl, vl, sc_l
    torch.cuda.empty_cache()
    return mesh.gather_object(res)


def tp_kernel_rank_main(seed: int, rank: int, port: int, device: str,
                        lens) -> None:
    """``--tp-kernel-rank R``: rank R of the per-rank kernel check (started
    by rank 0's ``tp_kernel_phase``)."""
    import torch

    from production_stack_tpu_torch.parallel.mesh import die_with_parent

    from production_stack_tpu_torch.ops import paged_attention as pa
    from production_stack_tpu_torch.parallel.mesh import RankMesh

    die_with_parent(os.getppid())
    mesh = RankMesh.join(rank, 1, 1, TP, port, torch.device(device), TP_TIMEOUT_S)
    try:
        for quant in (False, True):
            tp_kernel_rank(torch, pa, mesh, seed, lens, quant)
    finally:
        mesh.close()


def tp_kernel_phase(torch, pa, device, seed, main_lens, card):
    """``paged_flash_decode_stats_tp`` on each of 2 ranks (this process and
    one it starts, both on this card over gloo), bf16 then int8 pools; then
    its device times at the per-rank shape (H 16, Hkv 4) on rank 0 alone:
    the kernel through the wrapper, its plain twin, SDPA, the bound.
    Returns the bf16 and int8 rows."""
    from production_stack_tpu_torch.parallel.mesh import RankMesh

    here = os.path.abspath(__file__)
    mesh = RankMesh.launch(1, 1, TP, device, TP_TIMEOUT_S, lambda r, port: [
        sys.executable, here, "--seed", str(seed), "--tp-kernel-rank", str(r),
        "--tp-port", str(port), "--tp-device", device.type,
        "--tp-lens", ",".join(map(str, main_lens))])
    results = {}
    try:
        for quant in (False, True):
            results[quant] = tp_kernel_rank(torch, pa, mesh, seed, main_lens, quant)
    finally:
        mesh.close()
    rows = {}
    for quant in (False, True):
        variant = "int8" if quant else "bf16"
        for res in results[quant]:
            log(f"tp kernel [{variant}] rank {res['rank']}: {json.dumps(res)}")
            if not res["ok"]:
                fail(f"tp kernel [{variant}] rank {res['rank']}: its slice disagrees "
                     f"with the plain version (max abs {res['max_abs_err']:.3e}, row "
                     f"rel {res['max_row_rel_err']:.3e})")
        row = run_kernel_case(torch, pa, "tp rank llama-3-8b B=4", 4, 32 // TP, 8 // TP,
                              128, main_lens, 32, seed, device, quant,
                              kernel=pa.paged_flash_decode_stats_tp)
        row.update(card=card, ranks=results[quant],
                   max_abs_err=max(r["max_abs_err"] for r in results[quant]))
        rows[variant] = row
    return rows


def tp_forced(torch, runner, prompt_ids, forced, steps):
    """One prefill of ``prompt_ids`` and ``steps`` one-step decode
    dispatches through ``runner.execute_async``; step s's input token is
    ``forced[i][s]`` (None: the run's own greedy tokens). Returns (the f32
    logits [steps + 1, B, V] on the CPU, each row's greedy tokens, the
    sequences)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.scheduler import ScheduledBatch, Sequence

    n = len(prompt_ids)
    per_row = (runner.num_kv_blocks - 1) // n
    seqs = []
    for i, ids in enumerate(prompt_ids):
        s = Sequence(f"tf-{i}", list(ids), SamplingParams(
            temperature=0.0, max_tokens=4 * steps, ignore_eos=True))
        s.block_ids = list(range(1 + i * per_row, 1 + (i + 1) * per_row))
        seqs.append(s)
    runner.logits_sink = sink = []
    out = runner.execute_async(ScheduledBatch(
        "prefill", seqs, chunk_starts=[0] * n,
        chunk_lens=[len(x) for x in prompt_ids])).fetch()[0]
    greedy = [[t[0]] for t in out]
    for s in seqs:
        s.num_computed_tokens = s.num_tokens
    for step in range(steps):
        for i, s in enumerate(seqs):
            s.output_token_ids.append(forced[i][step] if forced else greedy[i][-1])
        out = runner.execute_async(ScheduledBatch(
            "decode", seqs, num_steps=1, decode_steps=[1] * n)).fetch()[0]
        for i, s in enumerate(seqs):
            s.num_computed_tokens += 1
            greedy[i].append(out[i][0])
    runner.logits_sink = None
    logits = torch.stack([x[:n].float().cpu() for x in sink])
    return logits, greedy, seqs


def tp_decode_timing(torch, runner, seqs, greedy, k=16, rounds=2):
    """``rounds`` fused decode dispatches of ``k`` steps after a forced run:
    ms per step by the runner's CUDA events around each dispatch (rank 0's
    stream, collective waits included) and by the host clock to its fetch;
    at tp > 1 also rank 0's host ms inside collectives per step."""
    from production_stack_tpu_torch.engine.scheduler import ScheduledBatch

    out = []
    for _ in range(rounds):
        for i, s in enumerate(seqs):
            s.output_token_ids.append(greedy[i][-1])
        ev0 = runner.decode_device_seconds_total
        coll0 = runner.tp.collective_seconds if runner.tp is not None else 0.0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        toks = runner.execute_async(ScheduledBatch(
            "decode", seqs, num_steps=k, decode_steps=[k] * len(seqs))).fetch()[0]
        wall = time.monotonic() - t0
        for i, s in enumerate(seqs):
            s.num_computed_tokens += k
            s.output_token_ids.extend(toks[i][:-1])
            greedy[i].append(toks[i][-1])
        row = {"ms_per_step_events": 1e3 * (runner.decode_device_seconds_total - ev0) / k,
               "ms_per_step_wall": 1e3 * wall / k}
        if runner.tp is not None:
            row["collective_host_ms_per_step"] = 1e3 * (
                runner.tp.collective_seconds - coll0) / k
        out.append(row)
    return out


TP_SPANS = ("tp.all_reduce", "tp.all_gather", "tp.stage_d2h", "tp.exchange",
            "tp.stage_h2d")


def tp_profile_step(torch, runner, seqs, greedy):
    """One one-step decode dispatch under torch.profiler, on rank 0: host
    ms in the collectives' record_function ranges (``tp.all_reduce`` and
    ``tp.all_gather``, and their parts: the staging copy to the host, which
    waits for the rank's queued device work; the gloo exchange, which waits
    for the other rank; the copy back), the device's busy ms (kernels and
    copies of this process) and the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.engine.scheduler import ScheduledBatch

    for i, s in enumerate(seqs):
        s.output_token_ids.append(greedy[i][-1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        toks = runner.execute_async(ScheduledBatch(
            "decode", seqs, num_steps=1, decode_steps=[1] * len(seqs))).fetch()[0]
        wall = time.monotonic() - t0
    for i, s in enumerate(seqs):
        s.num_computed_tokens += 1
        greedy[i].append(toks[i][0])
    spans = {name: [0, 0.0] for name in TP_SPANS}
    busy_us = 0.0
    for evt in prof.events():
        on_device = str(evt.device_type).endswith("CUDA")
        if on_device:
            busy_us += evt.time_range.elapsed_us()
        elif evt.name in spans:     # the host range, not its device mirror
            spans[evt.name][0] += 1
            spans[evt.name][1] += evt.time_range.elapsed_us() / 1e3
    out = {"step_wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3}
    for name, (calls, ms) in spans.items():
        out[name] = {"calls": calls, "ms": ms}
    out["collective_share"] = (spans["tp.all_reduce"][1]
                               + spans["tp.all_gather"][1]) / (1e3 * wall)
    return out


def tp_served(torch, engine, prompts, forced_run, max_tokens=32):
    """The tp engine behind the HTTP server: a 4-token warm-up request, then
    4 concurrent requests (2 greedy, 2 seeded; completions and streamed
    chat). Every rank's report is read with its launch counts reset to 0
    just before the 4 requests, and again right after; then one more step
    of the teacher-forced rows (``forced_run``: their sequences and tokens)
    is profiled. Returns the results by request name, and "_before",
    "_after" (the reports), "_steps" (rank 0's decode steps), "_wall",
    "_stats" and "_profile"."""
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    results = {}

    async def run():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        try:
            st, body, _, _ = await loop.run_in_executor(None, http, "GET", base + "/health")
            if st != 200:
                fail(f"tp /health: {st} {body}")
            st, body, _, _ = await loop.run_in_executor(
                None, http, "POST", base + "/v1/completions",
                {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0,
                 "ignore_eos": True})
            if st != 200 or body["usage"]["completion_tokens"] != 4:
                fail(f"tp warm-up request: {st} {body}")
            reqs = [
                ("completion greedy", "/v1/completions", False,
                 {"prompt": prompts[0], "max_tokens": max_tokens, "temperature": 0.0,
                  "ignore_eos": True}),
                ("completion seeded", "/v1/completions", False,
                 {"prompt": prompts[1], "max_tokens": max_tokens, "temperature": 0.8,
                  "top_p": 0.9, "seed": 1234, "ignore_eos": True}),
                ("chat stream greedy", "/v1/chat/completions", True,
                 {"messages": [{"role": "user", "content": prompts[2]}],
                  "max_tokens": max_tokens, "temperature": 0.0, "stream": True,
                  "stream_options": {"include_usage": True}, "ignore_eos": True}),
                ("chat stream seeded", "/v1/chat/completions", True,
                 {"messages": [{"role": "user", "content": prompts[3]}],
                  "max_tokens": max_tokens, "temperature": 0.7, "top_k": 50,
                  "seed": 7, "stream": True,
                  "stream_options": {"include_usage": True}, "ignore_eos": True}),
            ]
            results["_before"] = await engine.rank_reports(reset=True)
            steps0 = engine.runner.decode_steps_total

            def one(name, path, stream, body):
                t = time.monotonic()
                st, out, t_first, t_end = http("POST", base + path, body, stream)
                results[name] = (st, out, t, t_first, t_end)

            t0 = time.monotonic()
            with SmMhz() as clock:
                await asyncio.gather(*[loop.run_in_executor(None, one, *r) for r in reqs])
            results["_wall"] = time.monotonic() - t0
            results["_clock"] = clock.summary()
            results["_after"] = await engine.rank_reports()
            results["_steps"] = engine.runner.decode_steps_total - steps0
            results["_stats"] = engine.stats()
            results["_profile"] = await loop.run_in_executor(
                engine._executor, tp_profile_step, torch, engine.runner,
                *forced_run)
        finally:
            await server.stop()

    asyncio.run(run())
    return results


def tp_phase(torch, pa, device, seed, card, kv_cache_dtype, model=TP_MODEL):
    """llama-3-8b at full width (``model``: the name at full depth, or a
    ``cut_model`` directory; random bf16 weights from ``seed``) at tp = 2,
    both ranks on this card: the tp = 1 runner's
    teacher-forced greedy run (one prefill of 4 prompts + 16 one-step
    decodes), the same tokens forced through the tp = 2 engine's runner
    (max |logit diff| within ``tp_logit_bound``; equal argmax wherever tp =
    1's top-2 margin exceeds twice the bound), decode ms per step of both
    (eager), then the tp = 2 engine behind the HTTP server (every request
    200 with its tokens; the ranks' token digests agree; each rank's kernel
    counter reads exactly layers x decode steps of the run's variant and 0
    of the other; stats show tp 2, the rule's backend, per-rank pool bytes
    half the tp = 1 pool's) and one profiled step. Returns the run's
    launches summed over the ranks."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
    from production_stack_tpu_torch.models.config import resolve_model_config

    mc = resolve_model_config(model)
    quant = kv_cache_dtype == "int8"
    variant, other = (pa.INT8, pa.BF16) if quant else (pa.BF16, pa.INT8)
    name = f"tp [{kv_cache_dtype} KV]"
    tok = ByteTokenizer(mc.vocab_size)
    prompt_ids = [tok.encode(p) for p in graph_prompts(seed)]
    common = dict(model=model, dtype="bfloat16", attn_impl="paged", device=device.type,
                  max_model_len=4096, num_decode_steps=32, seed=seed,
                  kv_cache_dtype=kv_cache_dtype, num_kv_blocks=TP_KV_BLOCKS)

    # tp = 1: the reference logits and greedy tokens, eager.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ref = ModelRunner(EngineConfig(**common), mc)
    torch.cuda.synchronize()
    up1 = time.monotonic() - t0
    lg1, greedy1, seqs = tp_forced(torch, ref, prompt_ids, None, TF_STEPS)
    timing1 = tp_decode_timing(torch, ref, seqs, [list(g) for g in greedy1])
    pool1 = ref.hbm_kv_bytes
    peak1 = torch.cuda.max_memory_allocated() / 2**30
    del ref, seqs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{name}: tp=1 runner up in {up1:.1f} s, peak {peak1:.2f} GiB, pool "
        f"{pool1} bytes; decode {json.dumps(timing1)}")

    # tp = 2: rank 0 here, rank 1 a worker process on the same card.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = ServingEngine(EngineConfig(**common, tensor_parallel_size=TP,
                                        tp_timeout_s=TP_TIMEOUT_S, enable_warmup=True))
    up2 = time.monotonic() - t0
    try:
        runner = engine.runner
        lg2, greedy2, seqs = tp_forced(torch, runner, prompt_ids, greedy1, TF_STEPS)
        forced_run = (seqs, [list(g) for g in greedy2])
        timing2 = tp_decode_timing(torch, runner, *forced_run)
        diff = (lg2 - lg1).abs()
        max_diff = diff.max().item()
        bound = tp_logit_bound(mc.num_layers, lg1.numel())
        top2 = lg1.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        decided = margin > 2 * bound
        same = lg2.argmax(-1) == lg1.argmax(-1)
        prefix = []
        for i in range(len(prompt_ids)):
            n = 0
            while n < len(greedy1[i]) and greedy2[i][n] == greedy1[i][n]:
                n += 1
            prefix.append(n)
        logits_row = {
            "max_abs_logit_diff": max_diff, "bound": bound,
            "mean_abs_logit_diff": diff.mean().item(),
            "steps_checked": int(decided.sum()), "steps": int(decided.numel()),
            "argmax_equal_all": float(same.float().mean()),
            "common_greedy_prefix": prefix, "of": len(greedy1[0])}
        log(f"{name}: teacher-forced logits tp=2 vs tp=1 {json.dumps(logits_row)}")
        if not (math.isfinite(max_diff) and max_diff <= bound):
            fail(f"{name}: max |logit diff| {max_diff:.4f} over the bound {bound:.4f}")
        if not bool(same[decided].all()):
            fail(f"{name}: argmax differs at a step whose tp=1 top-2 margin exceeds "
                 f"twice the bound ({2 * bound:.4f})")
        served = tp_served(torch, engine, make_prompts(seed, 4), forced_run)
        reports = engine.tp_reports
    finally:
        engine.shutdown()
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    for rname in ("completion greedy", "completion seeded", "chat stream greedy",
                  "chat stream seeded"):
        st, out, _, _, _ = served[rname]
        if st != 200:
            fail(f"{name}: {rname}: HTTP {st}")
        if isinstance(out, list):
            usage = [e for e in out[:-1] if e.get("usage")]
            n_out = usage[-1]["usage"]["completion_tokens"] if usage else None
        else:
            n_out = out["usage"]["completion_tokens"]
        if n_out != 32:
            fail(f"{name}: {rname}: {n_out} tokens, want 32")
    ttft = [served[k][3] - served[k][2] for k in ("chat stream greedy", "chat stream seeded")]
    before, after, steps = served["_before"], served["_after"], served["_steps"]
    stats = served["_stats"]
    launches = 0
    for b_rep, a_rep in zip(before, after):
        r = a_rep["rank"]
        counts = a_rep["launch_counts"]
        rank_steps = a_rep["decode_steps_total"] - b_rep["decode_steps_total"]
        if steps <= 0 or rank_steps != steps or counts[variant] != mc.num_layers * steps \
                or counts[other]:
            fail(f"{name}: rank {r} counted {counts} over {rank_steps} decode steps "
                 f"(rank 0: {steps}): want {mc.num_layers} x steps of {variant}, "
                 f"none of {other}")
        if a_rep["hbm_kv_bytes"] * TP != pool1:
            fail(f"{name}: rank {r} holds {a_rep['hbm_kv_bytes']} pool bytes, not half "
                 f"of the tp=1 pool's {pool1}")
        launches += counts[variant]
    if len({rep["token_digest"] for rep in after}) != 1 or \
            len({rep["token_digest"] for rep in reports}) != 1:
        fail(f"{name}: the ranks' token digests differ: {after} / {reports}")
    want_backend = "nccl" if torch.cuda.device_count() >= TP else "gloo"
    per_dev = list(stats["hbm_kv_bytes_per_device"].values())
    if (stats["mesh_tp_size"], stats["tp_backend"]) != (TP, want_backend) or \
            per_dev != [pool1 // TP] * TP or stats["graph_families"] or \
            stats["decode_graph_dispatches_total"]:
        fail(f"{name}: stats show tp {stats['mesh_tp_size']}, backend "
             f"{stats['tp_backend']} (want {want_backend}), per-rank pool bytes "
             f"{per_dev} (want {pool1 // TP} each), {stats['graph_families']} graph "
             "families")
    summary = {
        "card": card, "model": model, "kv_cache_dtype": kv_cache_dtype, "tp": TP,
        "backend": stats["tp_backend"], "engine_up_s": up2, "decode_steps": steps,
        "launches_per_rank": [rep["launch_counts"][variant] for rep in after],
        "token_digest_after_served": after[0]["token_digest"],
        "token_digest_at_stop": reports[0]["token_digest"], "ttft_s_streamed": ttft,
        "wall_s": served["_wall"], "aggregate_tok_s": 4 * 32 / served["_wall"],
        "decode_ms_per_step_tp1_eager": timing1, "decode_ms_per_step_tp2_eager": timing2,
        "profile_one_step": served["_profile"],
        "peak_gib_per_rank": [max(b_rep["peak_bytes"], a_rep["peak_bytes"]) / 2**30
                              for b_rep, a_rep in zip(before, after)],
        "peak_gib_tp1": peak1,
        "weight_gib_per_rank": [rep["weight_bytes"] / 2**30 for rep in after],
        "head_f32_gib_per_rank": [rep["head_f32_bytes"] / 2**30 for rep in after],
        "hbm_kv_bytes_per_rank": [rep["hbm_kv_bytes"] for rep in after],
        "logits": logits_row, "sm_clock_mhz": served["_clock"],
    }
    log(f"tp result {json.dumps(summary)}")
    return launches, summary


# ------------------------------------------------------------- phase 7b: sp
SP_MODEL = "llama-3b"
SP_BUDGET = 1024                    # max_num_batched_tokens of the sp runs
SP_SHORT = 64                       # tokens of each of the 4 short prompts
SP_LONG = 3000                      # tokens of the long prompt: 3 chunks
SP_CUT_TOKENS = 16                  # prompt tokens of the cut meshes' runs
SP_ROW_BLOCKS = 256                 # blocks per forced row (4096 tokens)
SP_MESHES = (
    # (name, dp, sp, tp, cut to CUT_LAYERS, long prompt)
    ("sp2", 1, 2, 1, True, True),
    ("dp2-sp2-tp2", 2, 2, 2, True, False),
    ("sp2-tp3", 1, 2, 3, True, False),
)


def sp_prompts(seed: int, vocab: int, long: bool):
    """The sp runs' prompt ids, drawn from ``seed``: 4 x ``SP_SHORT`` tokens
    and, with ``long``, one of ``SP_LONG`` (a first chunk and two
    continuation chunks at ``SP_BUDGET``); else 4 x ``SP_CUT_TOKENS``."""
    rng = random.Random(seed * 7919 + 17)
    n = SP_SHORT if long else SP_CUT_TOKENS
    out = [[rng.randrange(3, vocab) for _ in range(n - i)] for i in range(4)]
    if long:
        out.append([rng.randrange(3, vocab) for _ in range(SP_LONG)])
    return out


def sp_forced(torch, runner, prompt_ids, forced, steps):
    """Prefill every prompt in chunks of at most ``SP_BUDGET`` tokens
    through ``runner.execute_async`` (the short prompts in one dispatch, a
    longer one alone, chunk after chunk), then ``steps`` one-step decode
    dispatches of every row; step s's input token is ``forced[i][s]``
    (None: the run's own greedy tokens). Returns (the f32 logits [rows,
    steps + 1, V] on the CPU, each row's greedy tokens, the sequences, the
    host seconds of the longest prompt's prefill dispatches)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.scheduler import ScheduledBatch, Sequence

    n = len(prompt_ids)
    seqs = []
    for i, ids in enumerate(prompt_ids):
        s = Sequence(f"sp-{i}", list(ids), SamplingParams(
            temperature=0.0, max_tokens=4 * steps, ignore_eos=True))
        s.block_ids = list(range(1 + i * SP_ROW_BLOCKS, 1 + (i + 1) * SP_ROW_BLOCKS))
        seqs.append(s)
    runner.logits_sink = sink = []
    first = [None] * n
    greedy = [None] * n
    long_s = 0.0
    groups = [[i for i in range(n) if len(prompt_ids[i]) <= SP_BUDGET // n]]
    groups += [[i] for i in range(n) if i not in groups[0]]
    for rows in groups:
        start = 0
        total = max(len(prompt_ids[i]) for i in rows)
        while start < total:
            batch = [i for i in rows if len(prompt_ids[i]) > start]
            lens = [min(SP_BUDGET // len(batch), len(prompt_ids[i]) - start)
                    for i in batch]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = runner.execute_async(ScheduledBatch(
                "prefill", [seqs[i] for i in batch], chunk_starts=[start] * len(batch),
                chunk_lens=lens)).fetch()[0]
            torch.cuda.synchronize()
            if len(rows) == 1:
                long_s += time.monotonic() - t0
            for j, i in enumerate(batch):
                if out[j]:
                    greedy[i] = [out[j][0]]
                    first[i] = sink[-1][j].float().cpu()
            start += max(lens)
    for s in seqs:
        s.num_computed_tokens = s.num_tokens
    steps_logits = []
    for step in range(steps):
        for i, s in enumerate(seqs):
            s.output_token_ids.append(forced[i][step] if forced else greedy[i][-1])
        out = runner.execute_async(ScheduledBatch(
            "decode", seqs, num_steps=1, decode_steps=[1] * n)).fetch()[0]
        steps_logits.append(sink[-1][:n].float().cpu())
        for i, s in enumerate(seqs):
            s.num_computed_tokens += 1
            greedy[i].append(out[i][0])
    runner.logits_sink = None
    logits = torch.stack([torch.stack(first)] + steps_logits, dim=1)
    return logits, greedy, seqs, long_s


def sp_bars(torch, name, lg, ref, served, greedy_ref, bound):
    """The logits bar (max |logit diff| of the forced runs within
    ``bound``) and the token bar (each served stream equals the reference's
    greedy tokens up to the first step whose reference top-2 margin is
    under twice the bound). Returns the numbers."""
    diff = (lg - ref).abs()
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    firsts = []
    for i, got in enumerate(served):
        want = greedy_ref[i]
        j = next((j for j in range(min(len(got), len(want))) if got[j] != want[j]),
                 None)
        low = next((j for j in range(margin.shape[1]) if margin[i, j] < 2 * bound),
                   None)
        firsts.append(j)
        if j is not None and (low is None or low > j):
            fail(f"{name}: stream {i} leaves the tp = 1 greedy tokens at step {j}, "
                 f"before any step whose tp = 1 margin is under 2 x the bound "
                 f"({2 * bound:.4f}); first low-margin step {low}")
        if len(got) != len(want):
            fail(f"{name}: stream {i} gave {len(got)} tokens, want {len(want)}")
    max_diff = diff.max().item()
    out = {"max_abs_logit_diff": max_diff, "mean_abs_logit_diff": diff.mean().item(),
           "bound": bound, "first_divergence": firsts,
           "min_margin": margin.min().item()}
    if not (math.isfinite(max_diff) and max_diff <= bound):
        fail(f"{name}: max |logit diff| {max_diff:.4f} over the bound {bound:.4f}")
    return out


def sp_serve(engine, prompt_ids, max_tokens):
    """Every prompt as a greedy stream on the engine API, all submitted
    together; on a mesh every rank's report with its counts reset just
    before, and after (with pool digests; None on one rank). Returns
    (tokens, before, after, rank 0's decode steps, wall seconds)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    res = {}

    async def run():
        await engine.start()
        mesh = engine.mesh is not None
        try:
            res["before"] = (await engine.rank_reports(reset=True) if mesh
                             else None)
            steps0 = engine.runner.decode_steps_total

            async def one(ids):
                toks = None
                async for out in engine.generate(
                        prompt_token_ids=list(ids), sampling=SamplingParams(
                            temperature=0.0, max_tokens=max_tokens,
                            ignore_eos=True)):
                    toks = out.token_ids
                return toks

            t0 = time.monotonic()
            res["tokens"] = await asyncio.gather(*[one(p) for p in prompt_ids])
            res["wall"] = time.monotonic() - t0
            res["after"] = (await engine.rank_reports(pool_digest=True)
                            if mesh else None)
            res["steps"] = engine.runner.decode_steps_total - steps0
            res["stats"] = engine.stats()
        finally:
            await engine.stop()

    asyncio.run(run())
    return res


def sp_reference(torch, common, mc, prompt_ids, timed):
    """The eager tp = 1 runner's forced greedy run (the reference logits
    and tokens), its long prefill's host seconds and, when ``timed``, two
    16-step decode dispatches' ms per step (else None)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.runner import ModelRunner

    ref = ModelRunner(EngineConfig(**common), mc)
    lg, greedy, seqs, long_s = sp_forced(torch, ref, prompt_ids, None, TF_STEPS)
    timing = tp_decode_timing(torch, ref, seqs, [list(g) for g in greedy]) \
        if timed else None
    del ref, seqs
    gc.collect()
    torch.cuda.empty_cache()
    return lg, greedy, long_s, timing


def sp_mesh_run(torch, pa, name, dp, sp, tp, model, mc, common, prompt_ids, ref,
                long):
    """One mesh's engine (every rank on this card over gloo): the reference
    tokens forced through its runner (the logits bar), with ``long`` (the
    full-depth sp = 2 run) its eager decode ms per step, then the prompts
    served greedily on the engine API (the token bar), with each rank's counts: ring calls of the kinds its chunks
    took, pools equal to their (0, 0, t) twins', the paged kernel's
    launches exactly layers x decode steps per rank (0 on the window
    path). Returns (the summary, the kernel's launches summed over the
    ranks)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine

    lg1, greedy1, long1, timing1 = ref
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = ServingEngine(EngineConfig(
        **common, data_parallel_size=dp, sequence_parallel_size=sp,
        tensor_parallel_size=tp, tp_timeout_s=TP_TIMEOUT_S))
    up = time.monotonic() - t0
    try:
        runner = engine.runner
        paged = runner.attn_impl == "paged"
        lg, greedy, seqs, long_s = sp_forced(torch, runner, prompt_ids, greedy1,
                                             TF_STEPS)
        timing = tp_decode_timing(torch, runner, seqs, [list(g) for g in greedy]) \
            if long else None
        del seqs
        bound = tp_logit_bound(mc.num_layers, lg1.numel())
        served = sp_serve(engine, prompt_ids, TF_STEPS + 1)
        reports = engine.tp_reports
    finally:
        engine.shutdown()
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    bars = sp_bars(torch, name, lg, lg1, served["tokens"], greedy1, bound)
    before, after, steps = served["before"], served["after"], served["steps"]
    launches = 0
    world = dp * sp * tp
    if [tuple(r["coords"]) for r in after] != [
            (d, s, t) for d in range(dp) for s in range(sp) for t in range(tp)]:
        fail(f"{name}: the ranks report grid points {[r['coords'] for r in after]}")
    for b_rep, a_rep in zip(before, after):
        r = a_rep["rank"]
        counts = a_rep["launch_counts"]
        rank_steps = a_rep["decode_steps_total"] - b_rep["decode_steps_total"]
        want = mc.num_layers * steps if paged else 0
        if steps <= 0 or rank_steps != steps or counts[pa.BF16] != want or \
                counts[pa.INT8]:
            fail(f"{name}: rank {r} counted {counts} over {rank_steps} decode "
                 f"steps (rank 0: {steps}): want {want} of {pa.BF16}, none of "
                 f"{pa.INT8}")
        launches += counts[pa.BF16]
        rings = a_rep["rings"] or {}
        if rings.get("first", 0) <= 0 or (long and rings.get("continuation", 0) <= 0):
            fail(f"{name}: rank {r} rang {rings}: want first-chunk"
                 f"{' and continuation' if long else ''} rings")
        twin = after[a_rep["coords"][2]]
        if a_rep["pool_digest"] != twin["pool_digest"]:
            fail(f"{name}: rank {r}'s pool differs from its (0, 0, "
                 f"{a_rep['coords'][2]}) twin's (digests "
                 f"{[x['pool_digest'] for x in after]}, token digests "
                 f"{[x['token_digest'] for x in after]})")
    if len({rep["token_digest"] for rep in after}) != 1 or \
            len({rep["token_digest"] for rep in reports}) != 1:
        fail(f"{name}: the ranks' token digests differ")
    st = served["stats"]
    if (st["mesh_dp_size"], st["mesh_sp_size"], st["mesh_tp_size"],
            st["mesh_devices"]) != (dp, sp, tp, world):
        fail(f"{name}: stats show mesh {st['mesh_dp_size']} x {st['mesh_sp_size']} x "
             f"{st['mesh_tp_size']} over {st['mesh_devices']} ranks")
    out = {
        "model": model, "dp": dp, "sp": sp, "tp": tp, "attn": "paged" if paged
        else "window", "backend": st["tp_backend"], "engine_up_s": up,
        "decode_steps": steps, "launches_per_rank": [r["launch_counts"][pa.BF16]
                                                     for r in after],
        "rings_rank0": after[0]["rings"], "ring_exchanges_rank0": after[0]["ring_exchanges"],
        "ring_host_s_max": max(r["ring_seconds"] for r in after),
        "long_prefill_s": long_s, "long_prefill_s_tp1": long1,
        "served_wall_s": served["wall"],
        "peak_gib_per_rank": [max(b["peak_bytes"], a["peak_bytes"]) / 2**30
                              for b, a in zip(before, after)],
        "logits": bars,
    }
    if long:
        # The second of two 16-step dispatches (the first pays first-use
        # costs of its shapes).
        out["decode_ms_per_step_events"] = timing[-1]["ms_per_step_events"]
        out["decode_ms_per_step_events_tp1"] = timing1[-1]["ms_per_step_events"]
    log(f"sp [{name}] result {json.dumps(out)}")
    return out, launches


def sp_phase(torch, pa, device, seed, card, cut_dirs, model=SP_MODEL):
    """Sequence parallelism, data parallelism and the replication fallback
    on this card (every rank a process sharing it over gloo), ``model``
    (llama-3b) at full width cut to ``CUT_LAYERS`` (``cut_model``'s
    directory): sp = 2 (4 x 64-token prompts and one of 3,000 tokens,
    1,024-token chunks: a first chunk and two continuation chunks, all
    rung); dp = 2 x sp = 2 x tp = 2 (8 ranks, the paged
    kernel per rank) and sp = 2 x tp = 3 (6 ranks: Hkv 8 and the 8,192-wide
    MLP do not divide by 3, so they replicate and decode takes the window
    path), 4 x 16-token prompts; each against an eager tp = 1 runner by the
    logits, token and replica bars (``sp_mesh_run``). Returns (the summary,
    the paged kernel's launches of the tp = 1 ranks' runs, those of the
    tp = 2 ranks' runs)."""
    from production_stack_tpu_torch.models.config import resolve_model_config

    out = {"card": card}
    launches_plain, launches_tp = 0, 0
    refs = {}
    for name, dp, sp, tp, cut, long in SP_MESHES:
        path = cut_model(torch, device, seed, model, cut_dirs) if cut else model
        mc = resolve_model_config(path)
        prompt_ids = sp_prompts(seed, mc.vocab_size, long)
        # A cut directory's weights are drawn from the seed on every rank
        # (the draw ``cut_model`` wrote): no rank reads the files.
        common = dict(model=path, dtype="bfloat16", device=device.type, seed=seed,
                      load_format="dummy",
                      max_model_len=SP_ROW_BLOCKS * 16, num_decode_steps=32,
                      max_num_batched_tokens=SP_BUDGET,
                      num_kv_blocks=len(prompt_ids) * SP_ROW_BLOCKS + 1)
        t0 = time.monotonic()
        if (path, long) not in refs:
            refs[path, long] = sp_reference(torch, common, mc, prompt_ids, long)
        row, n = sp_mesh_run(torch, pa, name, dp, sp, tp, path, mc, common,
                             prompt_ids, refs[path, long], long)
        row["seconds"] = time.monotonic() - t0
        out[name] = row
        if tp == 1:
            launches_plain += n
        else:
            launches_tp += n
    return out, launches_plain, launches_tp


# ---------------------------------------------------------------- phase 8
SURFACE_KEY = "smoke-key"
SURFACE_WATCHDOG_S = 420
SURFACE_HTTP_TIMEOUT_S = 120
# The router's EngineStatsScraper contract, preemptions, and the dispatch
# telemetry: present on /metrics before any traffic.
SURFACE_SERIES = (
    "vllm:num_requests_running", "vllm:num_requests_waiting",
    "vllm:gpu_prefix_cache_hits_total", "vllm:gpu_prefix_cache_queries_total",
    "vllm:gpu_cache_usage_perc", "vllm:num_preemptions_total",
    "pstpu:decode_dispatches_total", "pstpu:prefill_dispatches_total",
    "pstpu:dispatch_overlap_ratio", "pstpu:dispatch_gap_seconds_total",
    "pstpu:host_stall_seconds_total", "pstpu:live_tok_per_s",
    "pstpu:live_hbm_bw_pct")


def request(method, url, body=None, headers=None, timeout=SURFACE_HTTP_TIMEOUT_S):
    """(status, lower-cased headers, body text), on any status."""
    import urllib.error

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}, \
                resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read().decode()


def parse_metrics(text):
    """{series name: [(labels, value), ...]} of a Prometheus text
    exposition (this script's own parser)."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        out.setdefault(name, []).append(
            (dict(re.findall(r'(\w+)="([^"]*)"', labels)), float(value)))
    return out


def sse_stream(url, body, headers):
    """A streamed request: (status, the JSON chunks, t_sent, t_first
    chunk, t_end); the stream must end in [DONE]."""
    t0 = time.monotonic()
    st, events, t_first, t_end = http("POST", url, body, True, headers=headers,
                                      timeout=SURFACE_HTTP_TIMEOUT_S)
    if events[-1] != "[DONE]":
        fail(f"surface: stream to {url} did not end in [DONE]")
    return st, events[:-1], t0, t_first, t_end


def stream_tokens(chunks):
    """The output token ids a stream's pstpu payloads carry, checked
    contiguous."""
    toks = []
    for c in chunks:
        if "pstpu" not in c:
            continue
        if c["pstpu"]["off"] != len(toks):
            fail(f"surface: pstpu offsets not contiguous: {c['pstpu']['off']} "
                 f"after {len(toks)} tokens")
        toks += c["pstpu"]["toks"]
    return toks


def check_logprobs(name, chunks, chat, greedy, n_tokens):
    """A logprob stream's entries: one per token, every logprob <= 0, top
    lists non-increasing; a greedy row's chosen token is its top-1 (chat
    lists keep ids' order; a tie may swap equal values)."""
    entries = []
    for c in chunks:
        for ch in c["choices"]:
            lp = ch.get("logprobs")
            if not lp:
                continue
            if chat:
                entries += [(e["logprob"], e["token"],
                             [(t["token"], t["logprob"]) for t in e["top_logprobs"]])
                            for e in lp["content"]]
            else:
                entries += [(v, tok, sorted(((k, x) for k, x in top.items()),
                                            key=lambda kv: -kv[1]))
                            for v, tok, top in zip(lp["token_logprobs"], lp["tokens"],
                                                   lp["top_logprobs"])]
    if len(entries) != n_tokens:
        fail(f"surface: {name}: {len(entries)} logprob entries, want {n_tokens}")
    for chosen, tok, top in entries:
        vals = [v for _, v in top]
        if chosen > 0 or any(v > 0 for v in vals) or vals != sorted(vals, reverse=True):
            fail(f"surface: {name}: logprob above 0 or a top list out of order: "
                 f"{chosen} {top}")
        if chat and greedy and not (vals[0] == chosen and (
                top[0][0] == tok or (len(vals) > 1 and vals[1] == vals[0]))):
            fail(f"surface: {name}: greedy token {tok!r} ({chosen}) is not the "
                 f"top-1 {top[0]}")
        if not chat and greedy and vals and vals[0] > chosen:
            fail(f"surface: {name}: a top logprob {vals[0]} beats the greedy "
                 f"token's {chosen}")
    return len(entries)


def resume_check(base, headers, body, cut):
    """A seeded stream, cut after ``cut`` tokens and resumed from its pstpu
    payload (the delivered tokens and the seed): (the stream's tokens, the
    continuation's, equal tokens after the cut)."""
    st, chunks, *_ = sse_stream(base + "/v1/completions", body, headers)
    toks = stream_tokens(chunks)
    if st != 200 or len(toks) != body["max_tokens"]:
        fail(f"surface: resume source stream: HTTP {st}, {len(toks)} tokens")
    seed = chunks[0]["pstpu"]["seed"]
    st, rchunks, *_ = sse_stream(base + "/v1/completions", {
        **body, "resume_tokens": toks[:cut], "resume_seed": seed}, headers)
    rest = stream_tokens_from(rchunks, cut)
    if st != 200 or len(rest) != body["max_tokens"] - cut:
        fail(f"surface: resumed stream: HTTP {st}, {len(rest)} tokens after the cut")
    return toks, rest, sum(a == b for a, b in zip(toks[cut:], rest))


def stream_tokens_from(chunks, off):
    toks = []
    for c in chunks:
        if "pstpu" in c:
            if c["pstpu"]["off"] != off + len(toks):
                fail("surface: resumed stream's pstpu offsets do not start at the cut")
            toks += c["pstpu"]["toks"]
    return toks


def replay_ms_per_step(torch, train, key, steps=32, reps=3):
    """Replay ``key``'s head, ``steps`` step graphs and tail over all-zero
    inputs (every row budget 0, table 0: only the null block is written):
    ms per step between CUDA events, the median of ``reps``."""
    bf = train.buffers(*key)
    bf.packed.zero_()
    bf.prev_last.zero_()
    g = train.graphs[key].graphs
    out = []
    for _ in range(reps):
        g["head"].replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            g["step"].replay()
        end.record()
        g["tail"].replay()
        end.synchronize()
        out.append(start.elapsed_time(end) / steps)
    return sorted(out)[len(out) // 2]


def graph_vs_eager_dummy(torch, train, key):
    """One dispatch of all-zero inputs (budget 0, table 0: only the null
    block is written), replayed from ``key``'s graphs and run eagerly:
    whether each output is equal, and its max |diff|."""
    outs = []
    for replay in (True, False):
        bf = train.buffers(*key)
        bf.packed.zero_()
        bf.prev_last.zero_()
        if replay:
            g = train.graphs[key].graphs
            g["head"].replay()
            for _ in range(key[2]):
                g["step"].replay()
            g["tail"].replay()
        else:
            train.head(bf)
            for _ in range(key[2]):
                train.step(bf)
            train.tail(bf)
        torch.cuda.synchronize()
        outs.append([t.clone() for t in (bf.toks_all, bf.lp_chosen, bf.lp_top, bf.lp_ids)])
    return {name: [bool(torch.equal(a, b)), (a.double() - b.double()).abs().max().item()]
            for name, a, b in zip(("toks", "chosen_lp", "top_lp", "top_ids"), *outs)}


# The observability rounds' checks: a phase boundary may lag the previous
# phase's end by the loop's host time between a fetch and the next issue.
OBS_PHASE_GAP_S = 0.1
OBS_COVERAGE_MIN = 0.95
OBS_PROFILE_S = 2.0
# bf16 embeddings of one input alone and in a batch of 4 (other GEMM row
# counts and token buckets): max L2 distance of the unit vectors.
EMBED_BATCH_BOUND = 0.05
EMBED_LONG_TOKENS = 4000
SURFACE_TRACEPARENT = "00-{tid}-{sid}-01"


class OtlpCollector:
    """A localhost OTLP/HTTP JSON collector on a thread (the standard
    library's HTTP server): every POST /v1/traces batch, kept."""

    def __init__(self):
        import http.server

        batches = self.batches = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                batches.append(json.loads(self.rfile.read(n)))
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def spans(self):
        return [sp for b in self.batches for rs in b["resourceSpans"]
                for ss in rs["scopeSpans"] for sp in ss["spans"]]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(5)


def check_timeline(name, found, max_tokens, steps_of_round):
    """One stream's /debug/requests record: events from enqueue to finish,
    decode issue and fetch events paired, one per decode dispatch of its
    rows, its tokens the stream's; phases queue_wait, prefill, decode in
    order, queue wait ending where prefill starts, each later phase starting
    within ``OBS_PHASE_GAP_S`` of the previous one's end, together covering
    at least ``OBS_COVERAGE_MIN`` of enqueue to finish. Returns (decode steps
    of its dispatches, coverage, largest gap)."""
    recs = found["records"]
    if len(recs) != 1 or not recs[0]["finished"] or recs[0]["events_dropped"]:
        fail(f"surface: {name}: timeline {[(r['finished'], r['events_dropped']) for r in recs]}")
    ev = recs[0]["events"]
    names = [e["event"] for e in ev]
    issues = [e for e in ev if e["event"] == "decode_issue"]
    fetches = [e for e in ev if e["event"] == "decode_fetch"]
    if names[0] != "enqueue" or names[-1] != "finish" or \
            [e["step"] for e in issues] != [e["step"] for e in fetches] or \
            not set(e["step"] for e in issues) <= steps_of_round or \
            1 + sum(e["tokens"] for e in fetches) != max_tokens or \
            ev[-1]["output_tokens"] != max_tokens:
        fail(f"surface: {name}: events {names}, decode steps "
             f"{[e['step'] for e in issues]} / {[e['step'] for e in fetches]} "
             f"(round's {sorted(steps_of_round)}), tokens "
             f"{[e['tokens'] for e in fetches]}")
    ph = recs[0]["phases"]
    if [p["name"] for p in ph] != ["queue_wait", "prefill", "decode"] or \
            ph[0]["end"] != ph[1]["start"]:
        fail(f"surface: {name}: phases {ph}")
    gaps = [b["start"] - a["end"] for a, b in zip(ph, ph[1:])]
    gaps.append(ev[-1]["t"] - ph[-1]["end"])
    duration = ev[-1]["t"] - ev[0]["t"]
    coverage = sum(p["end"] - p["start"] for p in ph) / duration
    if min(gaps) < 0 or max(gaps) > OBS_PHASE_GAP_S or coverage < OBS_COVERAGE_MIN:
        fail(f"surface: {name}: phase gaps {gaps} s, coverage {coverage} of "
             f"{duration} s")
    return {e["step"] for e in issues}, coverage, max(gaps)


def check_spans(name, spans, trace_id, client_span, path, request_ids):
    """The OTLP spans of one stream: its server span "engine <path>" in the
    client's trace, parented to the client's span, status 200; its phase
    spans (queue_wait, prefill, decode) parented to the server span, inside
    it."""
    mine = [sp for sp in spans if sp["traceId"] == trace_id]
    server = [sp for sp in mine if sp["name"] == f"engine {path}"]
    if len(server) != 1 or server[0].get("parentSpanId") != client_span or \
            server[0]["kind"] != 2:
        fail(f"surface: {name}: server spans {server}")
    attrs = {a["key"]: a["value"] for a in server[0]["attributes"]}
    if attrs.get("http.status_code") != {"intValue": "200"}:
        fail(f"surface: {name}: server span attributes {attrs}")
    phases = sorted(sp["name"] for sp in mine if sp["name"].startswith("engine."))
    rids = {a["value"]["stringValue"] for sp in mine for a in sp["attributes"]
            if a["key"] == "request.id"}
    s0, s1 = int(server[0]["startTimeUnixNano"]), int(server[0]["endTimeUnixNano"])
    inside = all(s0 <= int(sp["startTimeUnixNano"]) <= int(sp["endTimeUnixNano"]) <= s1
                 for sp in mine if sp["name"].startswith("engine."))
    if phases != ["engine.decode", "engine.prefill", "engine.queue_wait"] or \
            rids != set(request_ids) or not inside or any(
                sp.get("parentSpanId") != server[0]["spanId"]
                for sp in mine if sp["name"].startswith("engine.")):
        fail(f"surface: {name}: phase spans {phases}, request ids {rids}, inside "
             f"the server span {inside}")
    return len(mine)


def trace_kernel_events(path):
    """A Chrome trace's CUDA kernel events: (count, the paged kernel's
    count, cudaGraphLaunch runtime calls, the first few kernel names)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = sum(1 for e in events if e.get("name") == "cudaGraphLaunch")
    paged = sum("paged_decode" in e.get("name", "") for e in kernels)
    names = sorted({e.get("name", "")[:60] for e in kernels})[:8]
    return len(kernels), paged, launches, names


async def observability_steps(torch, pa, engine, base, auth, ex, gate, round_bodies,
                              want_toks, n_layers, max_tokens, prompts):
    """The surface phase's observability, embedding and tool steps on its
    warm llama-3b server: (1) the 4 streams with the flight recorder and
    an OTLP tracer (a localhost collector) attached and detached, alternated
    on, off, off, on: every on round's timelines and spans checked; (2) one
    round inside a ``POST /debug/profile`` window (a second arm 409, the
    status finished, the trace's CUDA kernels); (3) /v1/embeddings of the 4
    prompts while a round decodes, unit norms, alone against batched,
    rerank scores against the embeddings, the embed's ms for the 4 prompts
    and for one ~4000-token prompt, the rerank's ms; (4) a forced
    ``tool_choice`` chat request, streamed and not. Every round's tokens
    equal ``want_toks``, only graphs replay, and the kernel counts
    ``n_layers`` x decode steps."""
    import numpy as np

    from production_stack_tpu_torch import tracing

    r = engine.runner
    train = r.decode_train
    sched = engine.scheduler
    recorder = engine.recorder
    collector = OtlpCollector()
    out = {"fields": ["round", "attached", "ms_per_step_events", "ttft_s_mean",
                      "wall_s", "decode_steps", "sm_clock_mhz_mean"], "rounds": []}

    def attach(on):
        engine.recorder = recorder if on else None
        if on:
            os.environ["OTEL_EXPORTER_OTLP_ENDPOINT"] = collector.url
            os.environ["OTEL_SERVICE_NAME"] = "chip-smoke-engine"
        else:
            os.environ.pop("OTEL_EXPORTER_OTLP_ENDPOINT", None)
        tracing.reset_tracer()

    async def one_round(name, during=None, eager_ok=False):
        """The 4 streams, each with its x-request-id and traceparent;
        ``during`` runs once the round's rows decode. Returns the round's
        facts and ``during``'s result."""
        gate["want"] = 4
        pa.reset_launch_counts()
        steps0, dev0 = r.decode_steps_total, r.decode_device_seconds_total
        eager0, d0 = train.eager_dispatches_total, engine.decode_dispatches_total
        tag = f"{len(out['rounds']):02d}"
        ids = [f"obs-{tag}-{i}" for i in range(4)]
        tps = [(f"{tag}{i:02d}" + "ab" * 14, f"{i + 1:016x}") for i in range(4)]
        t0 = time.monotonic()
        with SmMhz() as clock:
            streams = asyncio.gather(*[
                ex(sse_stream, base + path, body, {
                    **auth, "x-request-id": ids[i], "traceparent":
                    SURFACE_TRACEPARENT.format(tid=tps[i][0], sid=tps[i][1])})
                for i, (path, body) in enumerate(round_bodies(False))])
            extra = None
            if during is not None:
                while sched.num_running == 0 and not streams.done():
                    await asyncio.sleep(0.002)
                extra = await during()
            res = await streams
            wall = time.monotonic() - t0
        steps = r.decode_steps_total - steps0
        launches = pa.launch_counts()
        toks = [stream_tokens(c) for _, c, *_ in res]
        eager = train.eager_dispatches_total - eager0
        if any(st != 200 for st, *_ in res) or toks != want_toks:
            fail(f"surface: {name}: HTTP {[st for st, *_ in res]}, tokens equal to the "
                 f"logprobs-off round's: {[a == b for a, b in zip(toks, want_toks)]}")
        if (eager and not eager_ok) or steps <= 0 or \
                launches[pa.BF16] != n_layers * steps or launches[pa.INT8]:
            fail(f"surface: {name}: {eager} eager decode dispatches, launches "
                 f"{launches} over {steps} decode steps")
        row = {"ms_per_step_events": 1e3 * (r.decode_device_seconds_total - dev0) / steps,
               "ttft_s": [res[i][3] - gate["open"] for i in (0, 1, 3)],
               "wall_s": wall, "decode_steps": steps,
               "decode_dispatches": engine.decode_dispatches_total - d0,
               "sm_clock_mhz": clock.summary()}
        return row, ids, tps, extra

    def keep(name, attached, row):
        clock = row["sm_clock_mhz"]
        out["rounds"].append([name, attached, row["ms_per_step_events"],
                              sum(row["ttft_s"]) / 3, row["wall_s"], row["decode_steps"],
                              clock["mean"] if isinstance(clock, dict) else clock])

    try:
        # 1. recorder and tracer attached / detached, alternated
        coverage, gaps, n_spans, dropped = [], [], 0, 0
        for i, on in enumerate((True, False, False, True)):
            attach(on)
            d_before = engine._step_counter
            row, ids, tps, _ = await one_round(f"observability round {i}")
            keep(f"recorder+tracer {'on' if on else 'off'}", on, row)
            if not on:
                continue
            steps_of_round = set(range(d_before, engine._step_counter))
            decode_steps = set()
            for j, rid in enumerate(ids):
                st, _, body = await ex(request, "GET", base + f"/debug/requests/{rid}",
                                       None, auth)
                if st != 200:
                    fail(f"surface: /debug/requests/{rid}: HTTP {st}")
                found = json.loads(body)
                steps_j, cov, gap = check_timeline(rid, found, max_tokens, steps_of_round)
                decode_steps |= steps_j
                coverage.append(cov)
                gaps.append(gap)
                ids[j] = (rid, found["records"][0]["request_id"])
            if len(decode_steps) != row["decode_dispatches"]:
                fail(f"surface: the timelines name {len(decode_steps)} decode dispatches, "
                     f"the engine counted {row['decode_dispatches']}")
            st, _, body = await ex(request, "GET", base + "/debug/timeline?max_requests=4",
                                   None, auth)
            listed = {q["request_id"] for q in json.loads(body)["requests"]}
            if st != 200 or listed != {eid for _, eid in ids}:
                fail(f"surface: /debug/timeline lists {listed}")
            dropped += engine.stats()["trace_spans_dropped_total"]
            tracing.reset_tracer()   # posts what is queued
            want = {tid for tid, _ in tps}
            t_wait = time.monotonic()
            while sum(sp["traceId"] in want for sp in collector.spans()) < 16 and \
                    time.monotonic() - t_wait < 10:
                await asyncio.sleep(0.05)
            for j, (path, _) in enumerate(round_bodies(False)):
                n_spans += check_spans(ids[j][0], collector.spans(), tps[j][0],
                                       tps[j][1], path, [ids[j][1]])
        if dropped:
            fail(f"surface: {dropped} trace spans dropped")
        out["timelines"] = {"coverage_min": min(coverage), "largest_gap_s": max(gaps),
                            "spans_checked": n_spans, "spans_dropped": dropped}
        attach(False)
        log(f"surface observability so far {json.dumps(out)}")

        # 2. one round inside a profiler window
        async def profiled(name, eager=False):
            prof_dir = os.path.join(os.path.dirname(DETAIL_LOG), f"profile-{os.getpid()}")
            st, _, body = await ex(request, "POST", base + "/debug/profile", {
                "duration_s": OBS_PROFILE_S, "trace_dir": prof_dir}, auth)
            st2, _, _ = await ex(request, "POST", base + "/debug/profile",
                                 {"duration_s": 1.0}, auth)
            if st != 200 or st2 != 409:
                fail(f"surface: /debug/profile arm {st} {body}, second arm {st2}")
            saved = train.graphs
            if eager:
                train.graphs = {}
            try:
                row, *_ = await one_round(name, eager_ok=eager)
            finally:
                train.graphs = saved
            keep(name, False, row)
            t_wait = time.monotonic()
            while True:
                st, _, body = await ex(request, "GET", base + "/debug/profile", None, auth)
                status = json.loads(body)
                if status["active"] is None or time.monotonic() - t_wait > 120:
                    break
                await asyncio.sleep(0.2)
            last = status.get("last") or {}
            if status["active"] is not None or "trace_file" not in last:
                fail(f"surface: the profile did not finish: {status}")
            n_k, n_paged, n_graph, names = trace_kernel_events(last["trace_file"])
            facts = {"kernel_events": n_k, "paged_kernel_events": n_paged,
                     "graph_launch_calls": n_graph, "kernel_names": names,
                     "trace_mib": os.path.getsize(last["trace_file"]) / 2**20,
                     "finish_wait_s": time.monotonic() - t_wait,
                     "window_s": last["stopped_at"] - last["started_at"],
                     "paged_launches_counted": n_layers * row["decode_steps"]}
            for f in os.listdir(prof_dir):
                os.remove(os.path.join(prof_dir, f))
            os.rmdir(prof_dir)
            return facts

        out["profile"] = await profiled("profiler window")
        if not out["profile"]["kernel_events"]:
            fail(f"surface: the profiled round's trace holds no CUDA kernel event: "
                 f"{out['profile']}")
        if out["profile"]["paged_kernel_events"]:
            out["profile"]["graph_replays"] = "kernels inside replayed graphs reported"
        else:
            # The profiler saw the graphs only as whole launches: one eager
            # round shows the kernels by name.
            out["profile"]["graph_replays"] = "whole graph launches only"
            out["profile_eager"] = await profiled("profiler window, eager round", True)
            if not out["profile_eager"]["paged_kernel_events"]:
                fail(f"surface: no paged kernel event in the profiled rounds: "
                     f"{out['profile']} {out['profile_eager']}")

        log(f"surface observability so far {json.dumps(out)}")
        # 3. embeddings while a round decodes, then alone, and rerank
        async def embed_mid_round():
            t = time.monotonic()
            st, _, body = await ex(request, "POST", base + "/v1/embeddings",
                                   {"input": prompts}, auth)
            return st, body, time.monotonic() - t

        e0 = r.embed_seconds_total
        row, _, _, (st, body, mid_s) = await one_round("round with embeds", embed_mid_round)
        keep("embeds mid-round", False, row)
        if st != 200:
            fail(f"surface: /v1/embeddings mid-round: HTTP {st} {body[:300]}")
        batched = np.array([d["embedding"] for d in json.loads(body)["data"]])
        norms = np.linalg.norm(batched, axis=1)
        alone, alone_ms = [], []
        for p in prompts:
            t = time.monotonic()
            st, _, body = await ex(request, "POST", base + "/v1/embeddings", {"input": p}, auth)
            alone_ms.append(1e3 * (time.monotonic() - t))
            alone.append(json.loads(body)["data"][0]["embedding"])
        dist = np.linalg.norm(np.array(alone) - batched, axis=1)
        t = time.monotonic()
        st4, _, body4 = await ex(request, "POST", base + "/v1/embeddings",
                                 {"input": prompts}, auth)
        batch_ms = 1e3 * (time.monotonic() - t)
        long_prompt = (" ".join(prompts) * 2)[:EMBED_LONG_TOKENS]
        t = time.monotonic()
        st5, _, body5 = await ex(request, "POST", base + "/v1/embeddings",
                                 {"input": long_prompt}, auth)
        long_ms = 1e3 * (time.monotonic() - t)
        docs = [p[:400] for p in prompts[1:]]
        query = prompts[0][:200]
        t = time.monotonic()
        st6, _, body6 = await ex(request, "POST", base + "/rerank",
                                 {"query": query, "documents": docs}, auth)
        rerank_ms = 1e3 * (time.monotonic() - t)
        st7, _, body7 = await ex(request, "POST", base + "/v1/embeddings",
                                 {"input": [query] + docs}, auth)
        if 200 != st4 or 200 != st5 or 200 != st6 or 200 != st7:
            fail(f"surface: embeddings / rerank HTTP {st4} {st5} {st6} {st7}")
        ev = np.array([d["embedding"] for d in json.loads(body7)["data"]])
        score_err = max(abs(x["relevance_score"] - float(ev[x["index"] + 1] @ ev[0]))
                        for x in json.loads(body6)["results"])
        long_usage = json.loads(body5)["usage"]["prompt_tokens"]
        if np.abs(norms - 1).max() > 1e-3 or dist.max() > EMBED_BATCH_BOUND or \
                score_err > 1e-3 or long_usage != EMBED_LONG_TOKENS:
            fail(f"surface: embedding norms {norms}, alone vs batched L2 {dist} (bound "
                 f"{EMBED_BATCH_BOUND}), rerank score vs dot product {score_err}, long "
                 f"prompt tokens {long_usage}")
        out["embed"] = {
            "mid_round_ms": 1e3 * mid_s, "batch4_ms": batch_ms, "alone_ms": alone_ms,
            "prompt_tokens_4": json.loads(body4)["usage"]["prompt_tokens"],
            "long_ms": long_ms, "long_tokens": long_usage, "rerank_ms": rerank_ms,
            "rerank_tokens": json.loads(body6)["usage"]["prompt_tokens"],
            "norm_max_abs_err": float(np.abs(norms - 1).max()),
            "alone_vs_batched_l2": dist.tolist(), "bound": EMBED_BATCH_BOUND,
            "rerank_vs_dot_max_abs": score_err,
            "runner_embed_seconds": r.embed_seconds_total - e0}

        log(f"surface observability so far {json.dumps(out)}")
        # 4. a forced tool_choice, streamed and not: the same final message
        tools = [{"type": "function", "function": {
            "name": "get_weather", "parameters": {
                "type": "object", "properties": {"location": {"type": "string"}}}}}]
        # With logprobs: most of llama-3b's ids are no text under the byte
        # tokenizer, so the entries (deferred to the finishing chunk with
        # tools) tell the two answers' tokens apart.
        tbody = {"messages": [{"role": "user", "content": prompts[2][:300]}],
                 "tools": tools, "max_tokens": 24, "temperature": 0.0,
                 "ignore_eos": True, "logprobs": True, "tool_choice": {
                     "type": "function", "function": {"name": "get_weather"}}}
        # An untimed priming request first: both answers then find the same
        # prefix-cache state (a cache hit prefills only the prompt's tail,
        # whose bf16 GEMMs have another row count than the cold prompt's).
        st, _, _ = await ex(request, "POST", base + "/v1/chat/completions", tbody, auth)
        if st != 200:
            fail(f"surface: tool call priming request: HTTP {st}")
        messages = []
        for stream in (False, True):
            pa.reset_launch_counts()
            steps0, eager0 = r.decode_steps_total, train.eager_dispatches_total
            if stream:
                st, chunks, *_ = await ex(sse_stream, base + "/v1/chat/completions",
                                          {**tbody, "stream": True}, auth)
                deltas = [c["choices"][0] for c in chunks if c["choices"]]
                calls = [d["delta"]["tool_calls"] for d in deltas
                         if d["delta"].get("tool_calls")]
                msg = {"content": "".join(d["delta"].get("content") or ""
                                          for d in deltas),
                       "tool_calls": calls[0] if calls else None,
                       "finish_reason": deltas[-1]["finish_reason"],
                       "logprobs": [(e["token"], e["logprob"]) for d in deltas
                                    for e in (d.get("logprobs") or {}).get(
                                        "content", [])]}
            else:
                st, _, body = await ex(request, "POST", base + "/v1/chat/completions",
                                       tbody, auth)
                ch = json.loads(body)["choices"][0]
                msg = {"content": ch["message"]["content"] or "",
                       "tool_calls": ch["message"].get("tool_calls"),
                       "finish_reason": ch["finish_reason"],
                       "logprobs": [(e["token"], e["logprob"])
                                    for e in ch["logprobs"]["content"]]}
            if msg["tool_calls"]:
                msg["tool_calls"] = [{k: v for k, v in c.items() if k not in ("id", "index")}
                                     for c in msg["tool_calls"]]
            steps = r.decode_steps_total - steps0
            launches = pa.launch_counts()
            if st != 200 or train.eager_dispatches_total != eager0 or \
                    launches[pa.BF16] != n_layers * steps or steps <= 0:
                fail(f"surface: tool call (stream {stream}): HTTP {st}, launches "
                     f"{launches} over {steps} steps")
            messages.append(msg)
        if messages[0] != messages[1] or len(messages[0]["logprobs"]) != 24:
            fail(f"surface: a forced tool_choice's final message, streamed "
                 f"{messages[1]} != not streamed {messages[0]}")
        out["tool_call"] = {"finish_reason": messages[0]["finish_reason"],
                            "parsed_as_call": bool(messages[0]["tool_calls"]),
                            "content_chars": len(messages[0]["content"]),
                            "logprob_entries_equal": len(messages[0]["logprobs"]),
                            "streamed_equals_unstreamed": True}
    finally:
        # The server's own state again: the recorder on, tracing off.
        engine.recorder = recorder
        os.environ.pop("OTEL_EXPORTER_OTLP_ENDPOINT", None)
        tracing.reset_tracer()
        collector.close()
    on = [x[2] for x in out["rounds"] if x[0] == "recorder+tracer on"]
    off = [x[2] for x in out["rounds"] if x[0] == "recorder+tracer off"]
    out["recorder_tracer_ms_per_step_delta"] = sum(on) / len(on) - sum(off) / len(off)
    log(f"surface observability {json.dumps(out)}")
    return out


def surface_phase(torch, pa, device, seed, card, model="llama-3b"):
    """llama-3b at full width (``model``: the name at full depth, or a
    ``cut_model`` directory; random bf16 weights, bf16 KV of 2049
    blocks, decode graphs captured at warm-up) behind ``OpenAIServer`` with
    an API key and a queue bound: /version and /metrics; the same 4
    streams with logprobs off, then on (1 completions logprobs 5, 1 chat
    top_logprobs 5): their tokens equal, no eager decode dispatch, the
    kernel's count layers x steps, the logprob entries well formed; a
    top_logprobs 20 request served eagerly; n = 2 and a 2-prompt
    completion; resume from a stream's pstpu payload (llama-3b bf16:
    equal tokens reported; tiny-llama-128dh float32: identical); drain; then
    on the engine API, logprobs from graphs + pipeline against the strict
    eager loop on the same batches, bit for bit. Returns (the main path's
    bf16 launches, the summary)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams, compute_logprobs
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    max_tokens = 64
    auth = {"Authorization": f"Bearer {SURFACE_KEY}", "x-pstpu-resume": "1"}
    # A hang anywhere in the phase dumps every thread's stack to stderr and
    # exits, well inside the run's limit.
    faulthandler.dump_traceback_later(SURFACE_WATCHDOG_S, exit=True)
    cfg = EngineConfig(model=model, dtype="bfloat16", attn_impl="paged",
                       device=device.type, max_model_len=4096, num_decode_steps=32,
                       seed=seed, enable_warmup=True, num_kv_blocks=BF16_KV_BLOCKS,
                       max_num_batched_tokens=WARM_PREFILL_BUDGET)
    torch.cuda.reset_peak_memory_stats()
    t_up = time.monotonic()
    engine = ServingEngine(cfg)
    n_layers = engine.model_config.num_layers
    prompts = make_prompts(seed + 1, 4)
    sched = engine.scheduler
    schedule = sched.schedule
    gate = {"want": 0}

    def gated(*a, **k):
        # A round's requests all wait before its first batch forms, so
        # rounds over HTTP form the same batches.
        if gate["want"] and len(sched.waiting) < gate["want"]:
            return None
        if gate["want"]:
            gate["open"] = time.monotonic()
        gate["want"] = 0
        return schedule(*a, **k)

    sched.schedule = gated
    out = {"card": card}

    def round_bodies(lp):
        # Chat streams send their first chunk (the role) with the first
        # token, so they time TTFT; a completions chunk waits for text,
        # and most of llama-3b's ids are no text under the byte tokenizer.
        comp = {"max_tokens": max_tokens, "ignore_eos": True, "stream": True,
                "stream_options": {"include_usage": True}}

        def chat(i):
            return {"messages": [{"role": "user", "content": prompts[i]}]}

        return [
            ("/v1/chat/completions", {**comp, **chat(0), "temperature": 0.0}),
            ("/v1/chat/completions", {**comp, **chat(1), "temperature": 0.8,
                                      "top_p": 0.9, "seed": 1234}),
            ("/v1/completions", {**comp, "prompt": prompts[2], "temperature": 0.7,
                                 "seed": 7, **({"logprobs": 5} if lp else {})}),
            ("/v1/chat/completions", {
                **comp, **chat(3), "temperature": 0.0,
                **({"logprobs": True, "top_logprobs": 5} if lp else {})}),
        ]

    async def run():
        loop = asyncio.get_running_loop()

        def ex(fn, *a):
            return loop.run_in_executor(None, fn, *a)

        server = OpenAIServer(engine, "127.0.0.1", 0, api_key=SURFACE_KEY,
                              max_queue_len=64, drain_timeout=120.0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        st0 = engine.stats()
        out["engine_up_s"] = time.monotonic() - t_up
        out["graphs"] = {k: st0[k] for k in (
            "graph_families", "graphs_captured", "graph_pool_bytes",
            "graph_families_logprobs", "graph_pool_bytes_logprobs",
            "graph_capture_seconds", "graph_step_nodes_max")}
        out["graphs"]["graph_families_without_logprobs"] = (
            st0["graph_families"] - st0["graph_families_logprobs"])
        out["graphs"]["graph_pool_bytes_without_logprobs"] = (
            st0["graph_pool_bytes"] - st0["graph_pool_bytes_logprobs"])
        # 1. /version, auth, /metrics before traffic
        st, _, body = await ex(request, "GET", base + "/version")
        if st != 200 or json.loads(body) != {"version": "0.1.0"}:
            fail(f"surface: /version {st} {body}")
        st, _, body = await ex(request, "POST", base + "/v1/completions",
                               {"prompt": "no key", "max_tokens": 2})
        if st != 401:
            fail(f"surface: a request without the bearer token got {st}, not 401")
        st, _, text = await ex(request, "GET", base + "/metrics")
        m0 = parse_metrics(text)
        missing = [s for s in SURFACE_SERIES if s not in m0]
        if st != 200 or missing:
            fail(f"surface: /metrics {st}, missing series {missing}")
        out["metrics_series"] = len(m0)
        st, _, body = await ex(request, "POST", base + "/v1/completions", {
            "prompt": "warm up", "max_tokens": 4, "temperature": 0.0,
            "ignore_eos": True}, auth)
        if st != 200 or json.loads(body)["usage"]["completion_tokens"] != 4:
            fail(f"surface: warm-up request {st} {body}")

        # 2. the same 4 streams, logprobs off then on, after an untimed
        # round of the same prompts: both timed rounds then find the same
        # prompt blocks in the prefix cache and form the same batches.
        rounds = {}
        for lp in (None, False, True):
            name = {None: "priming", False: "logprobs off", True: "logprobs on"}[lp]
            r = engine.runner
            steps0, dev0 = r.decode_steps_total, r.decode_device_seconds_total
            train = r.decode_train
            eager0, d0 = train.eager_dispatches_total, engine.decode_dispatches_total
            m_before = parse_metrics((await ex(request, "GET", base + "/metrics"))[2])
            gate["want"] = 4
            mid = {"running": 0}
            pa.reset_launch_counts()
            t0 = time.monotonic()
            with SmMhz() as clock:
                streams = asyncio.gather(*[
                    ex(sse_stream, base + path, body, auth)
                    for path, body in round_bodies(bool(lp))])
                # One /metrics scrape while the round's rows decode (the
                # loop thread must stay free to answer it: never block it).
                while sched.num_running == 0 and not streams.done():
                    await asyncio.sleep(0.002)
                if not streams.done():
                    mm = parse_metrics((await ex(request, "GET", base + "/metrics"))[2])
                    mid["running"] = mm["vllm:num_requests_running"][0][1]
                res = await streams
                wall = time.monotonic() - t0
            launches = pa.launch_counts()
            steps = r.decode_steps_total - steps0
            m_after = parse_metrics((await ex(request, "GET", base + "/metrics"))[2])
            toks = []
            for i, (st, chunks, ts, tf, te) in enumerate(res):
                usage = [c["usage"] for c in chunks if c.get("usage")]
                if st != 200 or not usage or usage[-1]["completion_tokens"] != max_tokens:
                    fail(f"surface: {name} stream {i}: HTTP {st}, usage {usage}")
                toks.append(stream_tokens(chunks))
                if len(toks[-1]) != max_tokens:
                    fail(f"surface: {name} stream {i}: {len(toks[-1])} pstpu tokens")
            eager = train.eager_dispatches_total - eager0
            if lp is None:
                continue
            rounds[lp] = {
                "toks": toks, "launches": launches, "steps": steps,
                "row": {
                    # From the moment the round's batch could form (all
                    # 4 requests waiting) to each chat stream's first chunk.
                    "ttft_s": [res[i][3] - gate["open"] for i in (0, 1, 3)],
                    "decode_ms_per_step_events": 1e3 * (
                        r.decode_device_seconds_total - dev0) / steps,
                    "decode_ms_per_step_wall": 1e3 * sum(
                        (res[i][4] - res[i][3]) / (max_tokens - 1)
                        for i in (0, 1, 3)) / 3,
                    "aggregate_tok_s": 4 * max_tokens / wall, "wall_s": wall,
                    "decode_steps": steps,
                    "decode_dispatches": engine.decode_dispatches_total - d0,
                    "eager_decode_dispatches": eager,
                    "dispatch_overlap_ratio": m_after["pstpu:dispatch_overlap_ratio"][0][1],
                    "sm_clock_mhz": clock.summary()}}
            row = rounds[lp]["row"]
            log(f"surface round {name} {json.dumps(row)}")
            if eager:
                fail(f"surface: {name}: {eager} eager decode dispatches after warm-up")
            if steps <= 0 or launches[pa.BF16] != n_layers * steps or launches[pa.INT8]:
                fail(f"surface: {name}: launches {launches} over {steps} decode steps, "
                     f"want {n_layers} x steps of {pa.BF16}")
            running_after = m_after["vllm:num_requests_running"][0][1]
            grown = (m_after["pstpu:decode_dispatches_total"][0][1]
                     - m_before["pstpu:decode_dispatches_total"][0][1])
            live_tok = m_after["pstpu:live_tok_per_s"][0][1]
            bw = m_after["pstpu:live_hbm_bw_pct"][0][1]
            row.update(metrics_running_mid=mid["running"], metrics_running_after=running_after,
                       metrics_decode_dispatches_grown=grown, live_tok_per_s=live_tok,
                       live_hbm_bw_pct=bw)
            if mid["running"] < 1 or running_after != 0 or grown <= 0 or \
                    not live_tok > 0 or not 0 < bw <= 100:
                fail(f"surface: {name}: /metrics mid-round running {mid['running']}, after "
                     f"{running_after}, decode dispatches grown {grown}, live_tok_per_s "
                     f"{live_tok}, live_hbm_bw_pct {bw}")
            if lp:
                rounds[lp]["entries"] = [
                    check_logprobs("completions logprobs 5 (seeded)", res[2][1], False,
                                   False, max_tokens),
                    check_logprobs("chat top_logprobs 5 (greedy)", res[3][1], True,
                                   True, max_tokens)]
        if rounds[True]["toks"] != rounds[False]["toks"]:
            diff = [i for i in range(4) if rounds[True]["toks"][i] != rounds[False]["toks"][i]]
            fail(f"surface: tokens with logprobs on differ from logprobs off in streams {diff}")
        out["round_logprobs_off"] = rounds[False]["row"]
        out["round_logprobs_on"] = rounds[True]["row"]
        out["logprob_entries"] = rounds[True]["entries"]
        out["launches"] = rounds[True]["launches"]

        # 3. top_logprobs 20: the bucket warm-up does not capture, eager
        train = engine.runner.decode_train
        eager0, graph0 = train.eager_dispatches_total, train.graph_dispatches_total
        d0 = engine.decode_dispatches_total
        st, chunks, *_ = await ex(sse_stream, base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts[0][:300]}],
            "max_tokens": 24, "temperature": 0.0, "ignore_eos": True, "stream": True,
            "logprobs": True, "top_logprobs": 20}, auth)
        n20 = check_logprobs("chat top_logprobs 20", chunks, True, True, 24)
        eager = train.eager_dispatches_total - eager0
        dispatches = engine.decode_dispatches_total - d0
        if st != 200 or eager != dispatches or dispatches <= 0 or \
                train.graph_dispatches_total != graph0:
            fail(f"surface: top_logprobs 20: {eager} eager of {dispatches} decode "
                 "dispatches (want all of them, none replayed)")
        out["top_logprobs_20"] = {"decode_dispatches": dispatches, "eager": eager,
                                  "entries": n20}

        # 5. n = 2 and a 2-prompt completion. At llama-3b's vocab most
        # tokens are ids the byte tokenizer renders as no text, so choices
        # are told apart by their tokens' logprobs.
        st, _, body = await ex(request, "POST", base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": prompts[1][:400]}], "n": 2,
            "seed": 21, "temperature": 0.9, "max_tokens": 24, "ignore_eos": True,
            "logprobs": True}, auth)
        nb = json.loads(body)
        seqs = [tuple(e["logprob"] for e in c["logprobs"]["content"])
                for c in nb.get("choices", [])]
        if st != 200 or [c["index"] for c in nb["choices"]] != [0, 1] or \
                len(set(seqs)) != 2 or nb["usage"]["completion_tokens"] != 48:
            fail(f"surface: n=2: HTTP {st}, {nb.get('usage')}, distinct {len(set(seqs))}")
        st, _, body = await ex(request, "POST", base + "/v1/completions", {
            "prompt": [prompts[2][:300], prompts[3][:500]], "temperature": 0.0,
            "max_tokens": 24, "ignore_eos": True, "logprobs": 0}, auth)
        mb_ = json.loads(body)
        texts = [tuple(c["logprobs"]["token_logprobs"]) for c in mb_.get("choices", [])]
        want_prompt = len(prompts[2][:300].encode()) + len(prompts[3][:500].encode())
        if st != 200 or len(texts) != 2 or len(set(texts)) != 2 or \
                mb_["usage"]["completion_tokens"] != 48 or \
                mb_["usage"]["prompt_tokens"] != want_prompt:
            fail(f"surface: 2-prompt completion: HTTP {st}, {mb_.get('usage')}")
        out["fanout"] = {"n2_usage": nb["usage"], "two_prompts_usage": mb_["usage"]}

        # 6. resume (llama-3b bf16: equal tokens reported)
        toks, rest, equal = await ex(resume_check, base, auth, {
            "prompt": prompts[0][:600], "max_tokens": 48, "temperature": 0.8,
            "seed": 99, "ignore_eos": True, "stream": True}, 20)
        out["resume_llama3b_bf16"] = {"cut": 20, "after_cut": len(rest),
                                      "equal_after_cut": equal}

        # 8. the logprob ops' device time: one family's step graph with
        # and without them, replayed alternately; and the ops alone.
        full_mb = engine.runner._decode_mb(1)
        keys = [(4, full_mb, 32, False, 0, False),
                (4, full_mb, 32, False, 8, False)]
        ms = {k: [] for k in keys}
        with SmMhz() as clock:
            for k in (keys[0], keys[1], keys[1], keys[0]):
                ms[k].append(await loop.run_in_executor(
                    engine._executor, replay_ms_per_step, torch, train, k))
        logits = torch.randn((4, engine.model_config.vocab_size), device=device)
        chosen = logits.argmax(-1).int()
        buf = [torch.zeros((32, 4), device=device), torch.zeros((32, 4, 8), device=device),
               torch.zeros((32, 4, 8), dtype=torch.int32, device=device)]
        j = torch.zeros((1,), dtype=torch.long, device=device)

        def lp_ops(i):
            c, t, ids = compute_logprobs(logits, chosen, 8)
            buf[0].index_copy_(0, j, c[None])
            buf[1].index_copy_(0, j, t[None])
            buf[2].index_copy_(0, j, ids[None])

        found = device_profile(torch, lp_ops, 32, "logprob ops")
        lp_ms, lp_by_kernel = (found[:2] if found is not None else
                               (events_ms(torch, lp_ops, 32, "logprob ops")[0], {}))
        out["logprob_cost"] = {
            "step_graph_ms_lpk0": ms[keys[0]], "step_graph_ms_lpk8": ms[keys[1]],
            "delta_ms_per_step": (sum(ms[keys[1]]) - sum(ms[keys[0]])) / 2,
            "ops_alone_device_ms_b4": lp_ms,
            "ops_alone_ms_by_kernel": {k[:60]: v for k, v in lp_by_kernel.items()},
            "sm_clock_mhz": clock.summary()}

        # 9. observability, embeddings, tools (the same 4 streams as the
        # logprobs-off round, whose tokens every round here must give).
        out["observability"] = await observability_steps(
            torch, pa, engine, base, auth, ex, gate, round_bodies, rounds[False]["toks"],
            n_layers, max_tokens, prompts)

        # 7. drain with one stream in flight
        free0 = engine.block_manager.num_free_blocks
        stream = loop.run_in_executor(None, sse_stream, base + "/v1/completions", {
            "prompt": prompts[1][:500], "max_tokens": max_tokens, "temperature": 0.0,
            "ignore_eos": True, "stream": True}, auth)
        while sched.num_running == 0:
            if stream.done():
                fail("surface: drain: the stream ended before it was seen running")
            await asyncio.sleep(0.005)
        drain = asyncio.ensure_future(server.drain())
        await asyncio.sleep(0)
        st_h, hdr_h, body_h = await ex(request, "GET", base + "/health")
        st_p, hdr_p, _ = await ex(request, "POST", base + "/v1/completions",
                                  {"prompt": "late", "max_tokens": 2}, auth)
        st, chunks, *_ = await stream
        await drain
        got = stream_tokens(chunks)
        fin = [c["choices"][0]["finish_reason"] for c in chunks
               if c["choices"] and c["choices"][0].get("finish_reason")]
        free1 = engine.block_manager.num_free_blocks
        if st_h != 503 or json.loads(body_h).get("status") != "draining" or \
                "retry-after" not in hdr_h or st_p != 503 or "retry-after" not in hdr_p \
                or st != 200 or len(got) != max_tokens or fin != ["length"] or free1 != free0:
            fail(f"surface: drain: /health {st_h} {body_h}, POST {st_p} {hdr_p}, stream "
                 f"{st} {len(got)} tokens {fin}, free blocks {free1} (before {free0})")
        out["drain"] = {"health": json.loads(body_h), "post_status": st_p,
                        "stream_tokens": len(got), "free_blocks": [free0, free1]}
        await server.stop()

        # 4. logprobs from graphs + pipeline against the strict eager loop
        # on the same batches (the engine API; all requests queued before
        # the loop starts). An untimed priming run first: both compared
        # runs then find the same prompt blocks in the prefix cache, so
        # their prefills compute the same chunks.
        cfg.enable_warmup = False
        lp_prompts = [p[:700] for p in prompts]
        lp_samplings = [dict(temperature=0.0, logprobs=5), dict(temperature=0.8, seed=3,
                                                                logprobs=8),
                        dict(temperature=0.0), dict(temperature=0.7, seed=5, logprobs=2)]
        got = {}
        saved, saved_prefill = train.graphs, engine.runner.prefill_train.graphs
        for mode in ("priming", "graph", "eager"):
            cfg.async_pipeline = cfg.overlap_dispatch = mode == "graph"
            train.graphs = saved if mode == "graph" else {}
            engine.runner.prefill_train.graphs = saved_prefill if mode == "graph" else {}
            e0, g0 = train.eager_dispatches_total, train.graph_dispatches_total

            async def one(p, extra):
                final = None
                async for o in engine.generate(prompt=p, sampling=SamplingParams(
                        max_tokens=40, ignore_eos=True, **extra)):
                    final = o
                return final.token_ids, final.logprobs

            tasks = [asyncio.ensure_future(one(p, s))
                     for p, s in zip(lp_prompts, lp_samplings)]
            await asyncio.sleep(0)
            await engine.start()
            got[mode] = await asyncio.gather(*tasks)
            await engine.stop()
            got[mode + "_dispatches"] = (train.eager_dispatches_total - e0,
                                         train.graph_dispatches_total - g0)
        del got["priming"]
        train.graphs = saved
        engine.runner.prefill_train.graphs = saved_prefill
        if got["graph"] != got["eager"]:
            rows = []
            for (gt, gl), (et, el) in zip(got["graph"], got["eager"]):
                diffs = [abs(a[0] - b[0]) for a, b in zip(gl or [], el or [])
                         if a is not None and b is not None]
                rows.append({"tokens_equal": gt == et, "first_token_diff": next(
                    (i for i, (a, b) in enumerate(zip(gt, et)) if a != b), None),
                    "lp_entries_differing": sum(d > 0 for d in diffs),
                    "max_abs_lp_diff": max(diffs, default=0.0)})
            dummy = await loop.run_in_executor(
                engine._executor, graph_vs_eager_dummy, torch, train,
                (4, engine.runner._decode_mb(1), 32, False, 8))
            fail(f"surface: logprobs (or tokens) from graphs + pipeline differ from the "
                 f"strict eager loop's on the same batches: {rows}; one dispatch of "
                 f"all-zero inputs, replayed against eager: {dummy}")
        if got["graph_dispatches"][0] or not got["eager_dispatches"][0]:
            fail(f"surface: graph run {got['graph_dispatches']}, eager run "
                 f"{got['eager_dispatches']} (eager, replayed) decode dispatches")
        out["graph_vs_eager_logprobs"] = {
            "equal": True, "rows": 4, "tokens_each": 40,
            "dispatches_graph_run": got["graph_dispatches"],
            "dispatches_eager_run": got["eager_dispatches"]}

    asyncio.run(run())
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    engine.shutdown()
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # 6. resume at float32 on a small model: identical
    small = ServingEngine(EngineConfig(
        model="tiny-llama-128dh", device=device.type, dtype="float32", attn_impl="window",
        max_model_len=512, num_kv_blocks=256, max_num_seqs=8, seed=seed,
        enable_warmup=True))

    async def small_run():
        server = OpenAIServer(small, "127.0.0.1", 0)
        await server.start()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, resume_check, f"http://127.0.0.1:{server.port}",
                {"x-pstpu-resume": "1"}, {
                    "prompt": "resume at float32 " * 6, "max_tokens": 48,
                    "temperature": 0.9, "seed": 17, "ignore_eos": True,
                    "stream": True}, 20)
        finally:
            await server.stop()

    toks, rest, equal = asyncio.run(small_run())
    small.shutdown()
    if rest != toks[20:]:
        fail(f"surface: float32 resume: {equal} of {len(rest)} tokens after the cut "
             "equal the uninterrupted stream's")
    out["resume_tiny_f32"] = {"cut": 20, "identical": True, "after_cut": len(rest)}
    faulthandler.cancel_dump_traceback_later()
    log(f"surface result {json.dumps(out)}")
    return out["launches"][pa.BF16], out


# ------------------------------------------------------------ phase 9: kvtier
KVTIER_BLOCKS = 1024                # 4 rows x ~2300 tokens + headroom
KVTIER_TOKENS = 32                  # output tokens per stream, restore rounds
KVTIER_DISAGG_TOKENS = 32
KVTIER_SPILL_TOKENS = 64
KVTIER_WATCHDOG_S = 600
KVTIER_SAMPLINGS = (dict(temperature=0.0), dict(temperature=0.8, top_p=0.9, seed=1234),
                    dict(temperature=0.0), dict(temperature=0.7, seed=7))


# The disagg pair's prefill engine's restore link rate (Gb/s, the KV tier's
# ``PSTPU_KV_RESTORE_LINK_GBPS``): so slow that a restore never beats
# recompute (``kv_offload/manager.py:restore_beats_recompute``).
PREFILL_NEVER_RESTORES = "1e-9"


def kvtier_config(kv_cache_dtype, seed, model="llama-3b", device="cuda", **over):
    """EngineConfig fields of every kvtier engine: ``model`` (llama-3b cut to
    ``CUT_LAYERS`` in the full run), block 16, paged kernel, decode and
    prefill graphs captured at warm-up (4 rows at most and a 512-token
    prefill budget, so warm-up stays short; an engine that starts after the
    first one has warmed finds its manifest in ``ELASTIC_CACHE`` and
    captures the default sampling variants only: kvtier serves no other).
    ``model``/``device``: a small model on the CPU rehearses the phase."""
    return dict(model=model, dtype="bfloat16", attn_impl="paged", device=device,
                max_model_len=4096, num_decode_steps=32, max_num_seqs=4, seed=seed,
                num_kv_blocks=KVTIER_BLOCKS, kv_cache_dtype=kv_cache_dtype,
                max_num_batched_tokens=WARM_PREFILL_BUDGET, enable_warmup=True,
                compilation_cache_dir=ELASTIC_CACHE, **over)


def kvtier_server_args(kv_cache_dtype, seed):
    """The same fields as ``python -m production_stack_tpu_torch.server.api_server``
    flags (the server's other defaults are EngineConfig's)."""
    return ["--dtype", "bfloat16", "--attn-impl", "paged", "--max-model-len", "4096",
            "--num-decode-steps", "32", "--max-num-seqs", "4", "--seed", str(seed),
            "--num-kv-blocks", str(KVTIER_BLOCKS), "--kv-cache-dtype", kv_cache_dtype,
            "--max-num-batched-tokens", str(WARM_PREFILL_BUDGET),
            "--compilation-cache-dir", ELASTIC_CACHE]


def kvtier_prompts(seed):
    """4 prompts that share a ~2048-token prefix (a system prompt), each
    with its own ~100-token tail (ByteTokenizer: one token per byte)."""
    rng = random.Random(seed + 77)
    words = ("shared context for every stream of the offload round keeps the same "
             "blocks in the host pool and the remote tier while tails differ").split()
    text = []
    while sum(len(w) + 1 for w in text) < 2048:
        text.append(rng.choice(words))
    prefix = " ".join(text)[:2048]
    return [prefix + f" | stream {i}: " + " ".join(rng.choice(words) for _ in range(14))
            for i in range(4)]


def kvtier_samplings(sampling_cls, max_tokens):
    return [sampling_cls(max_tokens=max_tokens, ignore_eos=True, **s)
            for s in KVTIER_SAMPLINGS]


def time_block_writes(torch, engine):
    """Wrap the engine's ``runner.write_blocks`` to sum its seconds (the
    host staging copy, the H2D copy and the scatter, synchronized), so a
    restore's time splits into the write and the rest (store round trips,
    unpacking, stacking). Returns the running totals."""
    r = engine.runner
    write = r.write_blocks
    tot = {"s": 0.0, "bytes": 0, "calls": 0}

    def timed(blocks, *arrays):
        t0 = time.monotonic()
        write(blocks, *arrays)
        if r.device.type == "cuda":
            torch.cuda.synchronize()
        tot["s"] += time.monotonic() - t0
        tot["bytes"] += sum(a.nbytes for a in arrays if a is not None)
        tot["calls"] += 1

    r.write_blocks = timed
    return tot


def gate_schedule(engine):
    """Hold the engine's scheduler until ``gate["want"]`` requests wait, so
    a round's rows form one prefill batch (bf16 GEMM bits depend on the
    batch's row count). Returns the gate."""
    sched = engine.scheduler
    schedule = sched.schedule
    gate = {"want": 0}

    def gated(*a, **k):
        if gate["want"] and len(sched.waiting) < gate["want"]:
            return None
        gate["want"] = 0
        return schedule(*a, **k)

    sched.schedule = gated
    return gate


async def kvtier_round(torch, pa, engine, gate, prompts, samplings, what,
                       writes=None):
    """Serve ``prompts`` concurrently on the engine API as one batch; check
    every stream's length, no eager decode dispatch, the kernel's own count
    = layers x decode steps, and every KV-tier failure counter 0. Returns
    (tokens per stream, TTFT per stream, a row of numbers)."""
    r = engine.runner
    train = r.decode_train
    steps0, dev0 = r.decode_steps_total, r.decode_device_seconds_total
    eager0, graph0 = train.eager_dispatches_total, train.graph_dispatches_total
    st0 = engine.stats()
    hist = engine.lifecycle.restore_round_trip
    restore0 = (hist.sum, hist.count)
    writes = writes if writes is not None else {"s": 0.0, "bytes": 0}
    write0 = (writes["s"], writes["bytes"])
    pa.reset_launch_counts()
    gate["want"] = len(prompts)
    t0 = time.monotonic()

    async def one(p, sp):
        first = last = None
        async for o in engine.generate(prompt=p, sampling=sp):
            if first is None:
                first = time.monotonic() - t0
            last = o
        return last, first

    with SmMhz() as clock:
        res = await asyncio.gather(*[one(p, sp) for p, sp in zip(prompts, samplings)])
        wall = time.monotonic() - t0
    counts = pa.launch_counts()
    st = engine.stats()
    steps = r.decode_steps_total - steps0
    n_layers = engine.model_config.num_layers
    variant = pa.INT8 if engine.config.kv_cache_quantized else pa.BF16
    other = pa.BF16 if variant == pa.INT8 else pa.INT8
    toks = [o.token_ids for o, _ in res]
    for i, (o, _) in enumerate(res):
        if len(o.token_ids) != samplings[i].max_tokens:
            fail(f"kvtier {what}: stream {i} gave {len(o.token_ids)} tokens")
    eager = train.eager_dispatches_total - eager0
    if r.device.type != "cuda":
        log(f"kvtier {what}: on {r.device}: no graphs and no kernel counter "
            "to hold (a rehearsal)")
    elif eager or train.graph_dispatches_total == graph0:
        fail(f"kvtier {what}: {eager} eager decode dispatches after warm-up "
             f"({train.graph_dispatches_total - graph0} replayed)")
    elif counts[variant] != n_layers * steps or counts[other]:
        fail(f"kvtier {what}: kernel counts {counts}, want {n_layers} x {steps} steps "
             f"of {variant}")
    bad = {k: st[k] for k in ("kv_spill_failures_total", "kv_restore_failures_total",
                              "kv_handoff_failures_total") if st[k]}
    if bad:
        fail(f"kvtier {what}: failure counters {bad}")
    row = {"wall_s": wall, "ttft_s": [f for _, f in res], "decode_steps": steps,
           "launches": counts[variant],
           "decode_ms_per_step_events": (1e3 * (r.decode_device_seconds_total - dev0)
                                         / steps if steps else None),
           "restored_tokens": (st["kv_restore_saved_tokens_total"]
                               - st0["kv_restore_saved_tokens_total"]),
           # admission restores (host and remote round trips, unpack, the
           # block writes): seconds summed, and how many
           "restore_s": hist.sum - restore0[0],
           "restores": hist.count - restore0[1],
           "restore_write_s": writes["s"] - write0[0],
           "restore_write_bytes": writes["bytes"] - write0[1],
           "prefix_hit_tokens": st["prefix_cache_hits"] - st0["prefix_cache_hits"],
           "spilled_blocks": st["kv_spilled_blocks_total"] - st0["kv_spilled_blocks_total"],
           "cached_tokens": [o.num_cached_tokens for o, _ in res],
           "sm_clock_mhz": clock.summary()}
    log(f"kvtier {what}: {json.dumps(row)}")
    return toks, row


async def kvtier_wait_spilled(engine, what, timeout_s=120.0):
    """Wait until the spill thread has written every registered block."""
    t0 = time.monotonic()
    off = engine.offload
    while off.spilled_blocks_total + off.spill_failures_total < \
            engine.block_manager.prefix_index_size:
        if time.monotonic() - t0 > timeout_s:
            fail(f"kvtier {what}: {off.spilled_blocks_total} of "
                 f"{engine.block_manager.prefix_index_size} blocks spilled in "
                 f"{timeout_s:.0f} s")
        await asyncio.sleep(0.02)
    return time.monotonic() - t0


def kvtier_link_rates(torch, runner, blocks, reps=3):
    """D2H and H2D GB/s of ``read_blocks`` / ``write_blocks`` over
    ``blocks`` (written back with their own bytes: nothing changes), and of
    a plain copy of the same bytes between one pinned host buffer and one
    device buffer; best of ``reps`` each, beside the SM clock."""
    cuda = runner.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    runner.read_blocks(blocks[:4])
    out = {"blocks": len(blocks)}
    with SmMhz() as clock:
        best = {"read_blocks": 1e9, "write_blocks": 1e9, "plain_d2h": 1e9, "plain_h2d": 1e9}
        total = {"read_blocks": 0.0, "write_blocks": 0.0}
        for _ in range(reps):
            sync()
            t0 = time.monotonic()
            arrays = runner.read_blocks(blocks)
            dt = time.monotonic() - t0
            best["read_blocks"] = min(best["read_blocks"], dt)
            total["read_blocks"] += dt
            sync()
            t0 = time.monotonic()
            runner.write_blocks(blocks, *arrays)
            sync()
            dt = time.monotonic() - t0
            best["write_blocks"] = min(best["write_blocks"], dt)
            total["write_blocks"] += dt
        nbytes = sum(a.nbytes for a in arrays if a is not None)
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
        dev = torch.empty(nbytes, dtype=torch.uint8, device=runner.device)
        dev.copy_(host, non_blocking=True)
        sync()
        for _ in range(reps):
            t0 = time.monotonic()
            host.copy_(dev, non_blocking=True)
            sync()
            best["plain_d2h"] = min(best["plain_d2h"], time.monotonic() - t0)
            t0 = time.monotonic()
            dev.copy_(host, non_blocking=True)
            sync()
            best["plain_h2d"] = min(best["plain_h2d"], time.monotonic() - t0)
    out["bytes"] = nbytes
    out.update({f"{k}_gbps": nbytes / s / 1e9 for k, s in best.items()})
    out.update({f"{k}_ms": 1e3 * s for k, s in best.items()})
    out.update({f"{k}_total_s": s for k, s in total.items()})
    out["sm_clock_mhz"] = clock.summary()
    del host, dev
    return out


def kvtier_peer_main(seed, kv_cache_dtype, kv_url, model, device):
    """The second engine process of the kvtier phase: on a line from stdin,
    a fresh engine on the same cache server restores the 4 streams' blocks
    from the remote tier (the fleet-sharing case) and serves them; then a
    fresh engine behind the port's server takes ``POST /prewarm`` and serves
    them again. Prints ``kvtier-peer ready`` and then one ``kvtier-peer
    {json}`` line on stdout."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.ops import paged_attention as pa
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    cfg = EngineConfig(**kvtier_config(kv_cache_dtype, seed, model, device,
                                       kv_remote_url=kv_url))
    prompts = kvtier_prompts(seed)
    samplings = kvtier_samplings(SamplingParams, KVTIER_TOKENS)
    out = {}

    async def run():
        loop = asyncio.get_running_loop()
        engine = ServingEngine(cfg)
        gate = gate_schedule(engine)
        writes = time_block_writes(torch, engine)
        await engine.start()
        print("kvtier-peer ready", flush=True)
        await loop.run_in_executor(None, sys.stdin.readline)
        out["remote"] = {}
        out["remote"]["tokens"], out["remote"]["row"] = await kvtier_round(
            torch, pa, engine, gate, prompts, samplings, f"{kv_cache_dtype} remote restore",
            writes)
        st = engine.stats()
        out["remote"]["shared_tier_hits"] = st["kv_shared_tier_hits_total"]
        await engine.stop()
        engine.shutdown()
        del engine
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        engine = ServingEngine(cfg)
        gate = gate_schedule(engine)
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        t0 = time.monotonic()
        st, _, body = await loop.run_in_executor(
            None, request, "POST", f"http://127.0.0.1:{server.port}/prewarm",
            {"top_k": 16, "max_blocks": 4096})
        res = json.loads(body)
        out["prewarm"] = {"http_s": time.monotonic() - t0, "answer": res}
        if st != 200 or not res.get("blocks"):
            fail(f"kvtier {kv_cache_dtype} prewarm: {st} {body}")
        out["prewarm"]["tokens"], out["prewarm"]["row"] = await kvtier_round(
            torch, pa, engine, gate, prompts, samplings, f"{kv_cache_dtype} prewarmed")
        await server.stop()
        engine.shutdown()

    asyncio.run(run())
    print("kvtier-peer " + json.dumps(out), flush=True)


def disagg_hops(pre, dec, body, key):
    """Both hops of one chat by hand, as the router drives them: POST
    /disagg/prefill to the prefill-role engine, then the stream from the
    decode-role engine with the transfer key. Returns (hop 1 s, tokens,
    first-token and end times)."""
    t0 = time.monotonic()
    st, _, text = request("POST", pre + "/disagg/prefill", body, {
        "x-pstpu-transfer-key": key, "x-pstpu-endpoint": "chat", "x-request-id": key})
    hop1 = time.monotonic() - t0
    if st != 200 or json.loads(text).get("status") != "handoff":
        fail(f"disagg hop 1 of {key}: {st} {text}")
    st, chunks, ts, tf, te = sse_stream(dec + "/v1/chat/completions", body, {
        "x-pstpu-disagg": "decode", "x-pstpu-transfer-key": key, "x-pstpu-resume": "1"})
    return hop1, stream_tokens(chunks), tf, te


def kvtier_disagg(torch, pa, engine, loop, pd, kv_cache_dtype, seed):
    """Both hops of 4 chat requests, one at a time, as the router drives
    them: POST /disagg/prefill to the prefill-role engine, then the stream
    from the decode-role engine with the transfer key. Each stream's tokens
    must equal the unified ``engine``'s on the same request (offload off,
    so it prefills cold as the prefill engine does); the decode engine
    replays its graphs (its kernel counter layers x its decode steps), the
    prefill engine forms no decode batch. Returns (launches, summary)."""
    pre, dec = pd.urls
    prompts = make_prompts(seed + 900 + (kv_cache_dtype == "int8"), 4)
    prompts = [p[:900] for p in prompts]
    request("POST", dec + "/debug/kernels/reset")
    d0 = json.loads(request("GET", dec + "/debug/kernels")[2])["stats"]
    p0 = json.loads(request("GET", pre + "/debug/kernels")[2])["stats"]
    rows, bodies = [], []
    for i, p in enumerate(prompts):
        sp = dict(KVTIER_SAMPLINGS[i])
        body = {"model": engine.config.model_name, "max_tokens": KVTIER_DISAGG_TOKENS,
                "ignore_eos": True, "stream": True,
                "messages": [{"role": "user", "content": p}], **sp}
        bodies.append(body)
        t0 = time.monotonic()
        hop1, toks, tf, te = disagg_hops(pre, dec, body,
                                         f"pstpu-transfer:kvtier-{kv_cache_dtype}-{i}")
        rows.append({"hop1_s": hop1, "ttft_s": tf - t0, "total_s": te - t0,
                     "tokens": toks})
    d1 = json.loads(request("GET", dec + "/debug/kernels")[2])
    p1 = json.loads(request("GET", pre + "/debug/kernels")[2])["stats"]
    dstats = d1["stats"]

    # The twins: the unified engine, offload off, one request at a time.
    saved = engine.scheduler.offload
    engine.scheduler.offload = None
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    async def twins():
        outs = []
        for i, p in enumerate(prompts):
            prompt = engine.tokenizer.apply_chat_template(
                [{"role": "user", "content": p}], add_generation_prompt=True)
            last = None
            async for o in engine.generate(prompt=prompt, sampling=SamplingParams(
                    max_tokens=KVTIER_DISAGG_TOKENS, ignore_eos=True,
                    **KVTIER_SAMPLINGS[i])):
                last = o
            outs.append(last.token_ids)
        return outs

    want = loop.run_until_complete(twins())
    engine.scheduler.offload = saved
    for i, (row, w) in enumerate(zip(rows, want)):
        if row["tokens"] != w:
            fail(f"kvtier disagg {kv_cache_dtype} stream {i}: handed-off tokens differ "
                 f"from the unified engine's at {next((j for j, (a, b) in enumerate(zip(row['tokens'], w)) if a != b), None)} "
                 f"({len(row['tokens'])} vs {len(w)} tokens)")
    steps = dstats["decode_steps_total"] - d0["decode_steps_total"]
    variant = pa.INT8 if kv_cache_dtype == "int8" else pa.BF16
    launches = d1["launch_counts"].get(variant, 0)
    n_layers = engine.model_config.num_layers
    on_card = engine.runner.device.type == "cuda"
    if on_card and (launches != n_layers * steps or not steps):
        fail(f"kvtier disagg {kv_cache_dtype}: decode engine's kernel counts "
             f"{d1['launch_counts']} for {steps} decode steps")
    eager = dstats["decode_eager_dispatches_total"] - d0["decode_eager_dispatches_total"]
    if on_card and eager:
        fail(f"kvtier disagg {kv_cache_dtype}: {eager} eager decode dispatches on the "
             "decode engine")
    if p1["decode_dispatches_total"] != p0["decode_dispatches_total"] or \
            p1["decode_dispatches_total"]:
        fail(f"kvtier disagg {kv_cache_dtype}: the prefill engine formed "
             f"{p1['decode_dispatches_total']} decode batches")
    if p1["kv_restore_saved_tokens_total"]:
        fail(f"kvtier disagg {kv_cache_dtype}: the prefill engine restored "
             f"{p1['kv_restore_saved_tokens_total']} tokens (every hop 1 prefills cold)")
    for name, s in (("prefill", p1), ("decode", dstats)):
        bad = {k: s[k] for k in ("kv_handoff_failures_total", "kv_spill_failures_total",
                                 "kv_restore_failures_total") if s[k]}
        if bad:
            fail(f"kvtier disagg {kv_cache_dtype}: {name} engine failure counters {bad}")
    n = len(prompts)
    summary_row = {
        "requests": n, "tokens_equal_unified": True, "decode_steps": steps,
        "decode_launches": launches,
        "ttft_s": [r["ttft_s"] for r in rows], "hop1_s": [r["hop1_s"] for r in rows],
        "handoff_bytes_per_request": (p1["kv_handoff_bytes_total"]
                                      - p0["kv_handoff_bytes_total"]) / n,
        "handoff_publish_s_per_request": (p1["kv_handoff_seconds_total"]
                                          - p0["kv_handoff_seconds_total"]) / n,
        "handoff_fetch_s_per_request": (dstats["kv_handoff_seconds_total"]
                                        - d0["kv_handoff_seconds_total"]) / n,
        "prompt_tokens": [len(engine.tokenizer.encode(engine.tokenizer.apply_chat_template(
            [{"role": "user", "content": p}], add_generation_prompt=True)))
            for p in prompts]}
    log(f"kvtier disagg {kv_cache_dtype}: {json.dumps(summary_row)}")
    # What the router's disagg round (phase 15 (c)) sends again.
    summary_row["hand"] = {"bodies": bodies, "tokens": [r["tokens"] for r in rows],
                           "ttft_s": [r["ttft_s"] for r in rows]}
    return launches, summary_row


def kvtier_phase(torch, pa, device, seed, card, kv_cache_dtype, kv_url,
                 model="llama-3b", router=False):
    """The KV tier on the card for one KV dtype (see the module docstring).
    With ``router``, the router phase's disagg round (c) runs on the
    phase's prefill/decode pair (its row and launches under
    ``out["router_disagg"]``). Returns (the kernel launches of the phase's
    timed paths, the summary)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.launch import launch_engines
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    kv = kv_cache_dtype
    faulthandler.dump_traceback_later(KVTIER_WATCHDOG_S, exit=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"card": card, "kv_cache_dtype": kv}
    launches = 0
    # The peer process and the disaggregated pair start while this
    # process's engine warms up.
    log_dir = os.path.join(os.path.dirname(DETAIL_LOG), f"kvtier-{kv}")
    os.makedirs(log_dir, exist_ok=True)
    peer_log = open(os.path.join(log_dir, "peer.log"), "w")
    peer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--kvtier-peer", kv,
         "--kv-url", kv_url, "--seed", str(seed), "--kvtier-model", model,
         "--kvtier-device", device.type],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=peer_log, text=True)
    common = [*kvtier_server_args(kv, seed), "--kv-remote-url", kv_url]
    pd_holder = {}

    def start_pair():
        try:
            pd_holder["pd"] = launch_engines(
                model, 2, engine_args=common, device=device.type,
                log_dir=log_dir,
                startup_timeout_s=300,
                # No prefix cache on the prefill engine, and a restore
                # admission that never beats recompute: every hop 1 of a
                # prompt (by hand, then through the router) prefills it
                # cold, in the same chunks. The decode engine spills each
                # handed-off prompt to the shared tier, and a hop 1 that
                # restored part of it would prefill the rest in another
                # chunk: bf16 sums in another order, and a top-p chat's
                # tokens may differ.
                per_engine_args=[["--role", "prefill", "--no-warmup",
                                  "--no-enable-prefix-caching"],
                                 ["--role", "decode"]],
                per_engine_env=[{"PSTPU_KV_RESTORE_LINK_GBPS": PREFILL_NEVER_RESTORES},
                                {}])
        except BaseException as e:  # noqa: BLE001 — reported by the phase
            pd_holder["error"] = e

    pair = threading.Thread(target=start_pair, daemon=True)
    pair.start()
    t_up = time.monotonic()
    engine = ServingEngine(EngineConfig(**kvtier_config(
        kv, seed, model, device.type, kv_remote_url=kv_url, kv_offload_cpu=True)))
    gate = gate_schedule(engine)
    writes = time_block_writes(torch, engine)
    loop = asyncio.new_event_loop()
    prompts = kvtier_prompts(seed)
    samplings = kvtier_samplings(SamplingParams, KVTIER_TOKENS)
    server = None
    try:
        async def start():
            server = OpenAIServer(engine, "127.0.0.1", 0)
            await server.start()
            return server

        server = loop.run_until_complete(start())
        out["engine_up_s"] = time.monotonic() - t_up
        rounds = {}

        def rnd(what, ps=prompts, sps=samplings):
            toks, row = loop.run_until_complete(kvtier_round(
                torch, pa, engine, gate, ps, sps, f"{kv} {what}", writes))
            rounds[what] = row
            return toks

        # 1. cold, device-cached twin, host-pool restore
        rnd("cold recompute")
        out["spill_wait_s"] = loop.run_until_complete(kvtier_wait_spilled(engine, kv))
        out["blocks_spilled"] = engine.offload.spilled_blocks_total
        twin = rnd("device prefix cache")
        engine.block_manager.reset_prefix_cache()
        restored = rnd("host-pool restore")
        if restored != twin:
            fail(f"kvtier {kv}: tokens after the host-pool restore differ from the "
                 f"device-cached round's: {[a == b for a, b in zip(restored, twin)]}")
        if rounds["host-pool restore"]["restored_tokens"] <= 0:
            fail(f"kvtier {kv}: the host-pool round restored nothing")
        # 4. /prefix_index = prefix_digest
        st, _, text = loop.run_until_complete(loop.run_in_executor(
            None, request, "GET", f"http://127.0.0.1:{server.port}/prefix_index"))
        entries, _ = engine.block_manager.prefix_digest()
        if st != 200 or json.loads(text)["entries"] != entries or not entries:
            fail(f"kvtier {kv}: /prefix_index {st} differs from prefix_digest")
        out["prefix_index_entries"] = len(entries)
        # D2H / H2D of whole blocks against plain pinned copies
        blocks = sorted(engine.block_manager._block_to_hash)[:512]
        out["link"] = kvtier_link_rates(torch, engine.runner, blocks)
        # 2. the remote tier, then prewarm, in the peer process
        line = peer.stdout.readline()
        if line.strip() != "kvtier-peer ready":
            fail(f"kvtier {kv}: peer process said {line!r} (exit {peer.poll()})")
        peer.stdin.write("go\n")
        peer.stdin.flush()
        line = peer.stdout.readline()
        peer.wait(120)
        if not line.startswith("kvtier-peer {") or peer.returncode != 0:
            fail(f"kvtier {kv}: peer process ended {peer.returncode} with {line!r}")
        got = json.loads(line[len("kvtier-peer "):])
        for what in ("remote", "prewarm"):
            if got[what]["tokens"] != twin:
                fail(f"kvtier {kv}: {what} tokens differ from the device-cached round's")
            rounds[what] = got[what]["row"]
        if rounds["remote"]["restored_tokens"] <= 0 or \
                rounds["prewarm"]["restored_tokens"] or \
                rounds["prewarm"]["prefix_hit_tokens"] <= 0:
            fail(f"kvtier {kv}: remote round restored {rounds['remote']['restored_tokens']}, "
                 f"prewarmed round restored {rounds['prewarm']['restored_tokens']} and hit "
                 f"{rounds['prewarm']['prefix_hit_tokens']} tokens")
        out["prewarm"] = got["prewarm"]["answer"]
        # 3. disagg through the pair launch.py started
        pair.join(300)
        if "error" in pd_holder or "pd" not in pd_holder:
            fail(f"kvtier {kv}: the prefill/decode pair did not start: "
                 f"{pd_holder.get('error')}")
        out["disagg_pair_up_s"] = pd_holder["pd"].ready_seconds
        n, out["disagg"] = kvtier_disagg(torch, pa, engine, loop, pd_holder["pd"],
                                         kv, seed)
        launches += n
        if router:
            out["router_disagg"] = router_disagg_round(
                torch, pa, pd_holder["pd"], engine.config.model_name, kv_url, kv,
                out["disagg"].pop("hand"), engine.model_config.num_layers)
        else:
            out["disagg"].pop("hand")
        # spilling on and off, alternated, on fresh short prompts
        spill = []
        for j, on in enumerate((True, False, True, False)):
            ps = [p[:200] for p in make_prompts(seed + 500 + 4 * j, 4)]
            engine.scheduler.offload = engine.offload if on else None
            rnd(f"spill {'on' if on else 'off'} {j}", ps,
                kvtier_samplings(SamplingParams, KVTIER_SPILL_TOKENS))
            row = rounds[f"spill {'on' if on else 'off'} {j}"]
            spill.append([on, row["decode_ms_per_step_events"],
                          1e3 * row["wall_s"] / KVTIER_SPILL_TOKENS, row["spilled_blocks"]])
        engine.scheduler.offload = engine.offload
        out["spill"] = {"runs": spill, "fields": ["spilling", "ms_per_step_events",
                                                  "ms_per_token_wall", "blocks_spilled"]}
        launches += sum(r["launches"] for r in rounds.values())
        out["rounds"] = rounds
        out["ttft_s"] = {k: sum(rounds[k]["ttft_s"]) / len(rounds[k]["ttft_s"]) for k in (
            "cold recompute", "device prefix cache", "host-pool restore", "remote",
            "prewarm")}
        st = engine.stats()
        out["stats"] = {k: st[k] for k in (
            "kv_spilled_blocks_total", "kv_offload_blocks", "prefix_index_size",
            "kv_restore_saved_tokens_total", "kv_shared_tier_hits_total",
            "kv_shared_tier_misses_total", "kv_chain_evictions_total",
            "kv_spill_failures_total", "kv_restore_failures_total")}
        loop.run_until_complete(server.stop())
    finally:
        if peer.poll() is None:
            peer.kill()
            peer.wait()
        pair.join(300)
        if "pd" in pd_holder:
            pd_holder["pd"].stop()
        engine.shutdown()
        loop.close()
        peer_log.close()
        faulthandler.cancel_dump_traceback_later()
    if device.type == "cuda":
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # The server and the scheduler's gate hold the engine too: all go
    # before the next KV dtype's engine is built.
    del engine, server, gate, writes
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"kvtier result {json.dumps(out)}")
    return launches, out


# ------------------------------------------------------ phase 9b: kvtier-tp
KVTIER_TP_BLOCKS = 1024             # 4 cold rows x ~2200 tokens + headroom
KVTIER_TP_TOKENS = 16               # output tokens per stream
KVTIER_TP_WATCHDOG_S = 900
# 2 greedy, 2 seeded streams, unfiltered: a seeded row's pick is the argmax
# of logits / T + its Gumbel field, so ``sampler_margin`` is its margin.
KVTIER_TP_SAMPLINGS = (dict(temperature=0.0), dict(temperature=0.8, seed=1234),
                       dict(temperature=0.0), dict(temperature=0.7, seed=7))


def kvtier_tp_config(kv_cache_dtype, seed, tp, model=TP_MODEL, device="cuda", **over):
    """EngineConfig fields of every kvtier-tp engine: llama-3-8b at full width
    and depth, random bf16 weights from ``seed``, block 16, the paged kernel,
    4 rows, K = 16; tp = 2 ranks share the card (no graph is captured at tp >
    1), a tp = 1 engine captures its decode graphs at warm-up."""
    fields = dict(model=model, dtype="bfloat16", attn_impl="paged", device=device,
                  max_model_len=4096, num_decode_steps=KVTIER_TP_TOKENS,
                  max_num_seqs=4, seed=seed, num_kv_blocks=KVTIER_TP_BLOCKS,
                  kv_cache_dtype=kv_cache_dtype, enable_warmup=True,
                  max_num_batched_tokens=WARM_PREFILL_BUDGET,
                  tensor_parallel_size=tp, **over)
    if tp > 1:
        fields["tp_timeout_s"] = TP_TIMEOUT_S
    return fields


def kvtier_tp_server_args(kv_cache_dtype, seed):
    """``kvtier_tp_config``'s fields as the server's flags (tp per engine)."""
    return ["--dtype", "bfloat16", "--attn-impl", "paged", "--max-model-len", "4096",
            "--num-decode-steps", str(KVTIER_TP_TOKENS), "--max-num-seqs", "4",
            "--seed", str(seed), "--num-kv-blocks", str(KVTIER_TP_BLOCKS),
            "--kv-cache-dtype", kv_cache_dtype,
            "--max-num-batched-tokens", str(WARM_PREFILL_BUDGET)]


async def kvtier_tp_round(pa, engine, gate, prompts, samplings, what):
    """Serve ``prompts`` concurrently on the engine API as one batch (a tp >
    1 engine, all eager): every stream's length; each rank's kernel counter
    exactly layers x its decode steps of the run's variant and 0 of the
    other (read from every rank, reset just before the round); every
    KV-tier failure counter 0. Returns (tokens per stream, a row)."""
    r = engine.runner
    st0 = engine.stats()
    hist = engine.lifecycle.restore_round_trip
    restore0 = (hist.sum, hist.count)
    before = await engine.rank_reports(reset=True)
    steps0 = r.decode_steps_total
    gate["want"] = len(prompts)
    t0 = time.monotonic()

    async def one(p, sp):
        first = last = None
        async for o in engine.generate(prompt=p, sampling=sp):
            if first is None:
                first = time.monotonic() - t0
            last = o
        return last, first

    with SmMhz() as clock:
        res = await asyncio.gather(*[one(p, sp) for p, sp in zip(prompts, samplings)])
        wall = time.monotonic() - t0
    after = await engine.rank_reports()
    st = engine.stats()
    steps = r.decode_steps_total - steps0
    n_layers = engine.model_config.num_layers
    variant = pa.INT8 if engine.config.kv_cache_quantized else pa.BF16
    other = pa.BF16 if variant == pa.INT8 else pa.INT8
    for i, (o, _) in enumerate(res):
        if len(o.token_ids) != samplings[i].max_tokens:
            fail(f"kvtier-tp {what}: stream {i} gave {len(o.token_ids)} tokens")
    per_rank = []
    for b_rep, a_rep in zip(before, after):
        counts = a_rep["launch_counts"]
        rank_steps = a_rep["decode_steps_total"] - b_rep["decode_steps_total"]
        per_rank.append(counts.get(variant, 0))
        if r.device.type != "cuda":
            continue
        if steps <= 0 or rank_steps != steps or counts[variant] != n_layers * steps \
                or counts[other]:
            fail(f"kvtier-tp {what}: rank {a_rep['rank']} counted {counts} over "
                 f"{rank_steps} decode steps (rank 0: {steps}): want {n_layers} x "
                 f"steps of {variant}, none of {other}")
    if r.device.type != "cuda":
        log(f"kvtier-tp {what}: on {r.device}: no kernel counter to hold (a rehearsal)")
    bad = {k: st[k] for k in ("kv_spill_failures_total", "kv_restore_failures_total",
                              "kv_handoff_failures_total") if st[k]}
    if bad:
        fail(f"kvtier-tp {what}: failure counters {bad}")
    row = {"wall_s": wall, "ttft_s": [f for _, f in res], "decode_steps": steps,
           "launches_per_rank": per_rank,
           "restored_tokens": (st["kv_restore_saved_tokens_total"]
                               - st0["kv_restore_saved_tokens_total"]),
           "restore_s": hist.sum - restore0[0], "restores": hist.count - restore0[1],
           "prefix_hit_tokens": st["prefix_cache_hits"] - st0["prefix_cache_hits"],
           "cached_tokens": [o.num_cached_tokens for o, _ in res],
           "sm_clock_mhz": clock.summary()}
    log(f"kvtier-tp {what}: {json.dumps(row)}")
    return [o.token_ids for o, _ in res], row


def kvtier_store_keys(engine, token_ids, n):
    """The tier's store keys of a prompt's first ``n`` full blocks."""
    from production_stack_tpu_torch.engine.kv_cache import _block_hash

    bs = engine.config.block_size
    prev, keys = b"", []
    for i in range(n):
        prev = _block_hash(prev, token_ids[i * bs:(i + 1) * bs])
        keys.append(engine.offload._store_key(prev))
    return keys


def kvtier_tier_blobs(engine, token_ids, n):
    """The tier's blobs of a prompt's first ``n`` full blocks, unpacked:
    from the host pool where it holds them, else from the remote tier."""
    from production_stack_tpu_torch.kv_offload.serde import unpack_chain

    off = engine.offload
    keys = kvtier_store_keys(engine, token_ids, n)
    if off.host_pool is not None and all(off.host_pool.contains(k) for k in keys):
        blobs = [off.host_pool.get(k) for k in keys]
    else:
        blobs = off.remote.multi_get(keys)
    return [off.unpack(unpack_chain(b)[1]) for b in blobs]


def kvtier_forced(torch, engine, prompt_ids, forced, steps):
    """Teacher forcing through the KV tier, with the engine idle, on its
    runner thread: each prompt's blocks are allocated in the engine's block
    manager, its tier-resident prefix restored (``offload.try_restore``:
    the host pool, else the remote tier), its tail prefilled, then
    ``steps`` one-step decode dispatches whose step-s input token is
    ``forced[i][s]``. Row 0's restored blocks, read back through
    ``read_blocks`` (every rank's heads), must equal the tier's blobs byte
    for byte. Returns (the f32 logits [steps + 1, B, V] on the CPU, the
    tokens each row restored)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.engine.scheduler import ScheduledBatch, Sequence

    runner, bm, off = engine.runner, engine.block_manager, engine.offload
    bs = engine.config.block_size
    seqs, restored, held = [], [], []
    # Every step's logits reach the sink only eagerly: no graph replays here.
    graphs, runner.decode_train.graphs = runner.decode_train.graphs, {}
    try:
        for i, ids in enumerate(prompt_ids):
            s = Sequence(f"kvtier-forced-{i}", list(ids), SamplingParams(
                temperature=0.0, max_tokens=4 * steps, ignore_eos=True))
            blocks, cached = bm.allocate_prompt(s.all_token_ids, seed=s.hash_seed)
            held.append(blocks)
            got = off.try_restore(s.all_token_ids, blocks, cached, seed=s.hash_seed)
            more = -(-(len(ids) + steps + 1) // bs) - len(blocks)
            extra = bm.allocate_blocks(more) if more > 0 else []
            if extra is None:
                fail("kvtier-tp forced: the pool is full")
            held.append(extra)
            s.block_ids = blocks + extra
            s.num_computed_tokens = cached + got
            restored.append(got)
            if i == 0:
                n = (cached + got) // bs
                want = kvtier_tier_blobs(engine, s.all_token_ids, n)
                have = runner.read_blocks(blocks[cached // bs:n])
                for j, blob in enumerate(want[cached // bs:]):
                    for a, b in zip(have, blob):
                        if (a is None) != (b is None) or (
                                a is not None and a[j].tobytes() != b.tobytes()):
                            fail(f"kvtier-tp forced: restored block {j} of row 0 "
                                 "differs from the tier's blob")
            seqs.append(s)
        runner.logits_sink = sink = []
        runner.execute_async(ScheduledBatch(
            "prefill", seqs, chunk_starts=[s.num_computed_tokens for s in seqs],
            chunk_lens=[s.num_tokens - s.num_computed_tokens for s in seqs]
        )).fetch()
        for s in seqs:
            s.num_computed_tokens = s.num_tokens
        for step in range(steps):
            for i, s in enumerate(seqs):
                s.output_token_ids.append(forced[i][step])
            runner.execute_async(ScheduledBatch(
                "decode", seqs, num_steps=1, decode_steps=[1] * len(seqs))).fetch()
            for s in seqs:
                s.num_computed_tokens += 1
        runner.logits_sink = None
        return torch.stack([x[:len(seqs)].float().cpu() for x in sink]), restored
    finally:
        runner.logits_sink = None
        runner.decode_train.graphs = graphs
        for blocks in held:
            bm.free_blocks(blocks)


def kvtier_tp_bar(torch, name, lg, ref, tokens, twin, samplings, bound):
    """The tp phase's check of a cross-mesh path: teacher-forced logits ``lg``
    (None for an HTTP path) within ``bound`` of the reference ``ref`` (tp = 2,
    the twin's tokens forced), and each stream's tokens equal to the twin's
    up to a step whose sampler margin under ``ref`` is at most twice the
    bound. Returns the row."""
    row = {"bound": bound}
    if lg is not None:
        diff = (lg - ref).abs()
        row.update(max_abs_logit_diff=diff.max().item(), mean_abs_logit_diff=diff.mean().item())
        if not (math.isfinite(row["max_abs_logit_diff"]) and row["max_abs_logit_diff"] <= bound):
            fail(f"kvtier-tp {name}: max |logit diff| {row['max_abs_logit_diff']:.4f} over "
                 f"the bound {bound:.4f}")
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > 2 * bound
        if not bool((lg.argmax(-1) == ref.argmax(-1))[decided].all()):
            fail(f"kvtier-tp {name}: argmax differs where the reference's top-2 margin "
                 f"exceeds twice the bound")
    firsts = []
    for i, (got, want) in enumerate(zip(tokens, twin)):
        t = next((t for t, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if t is None and len(got) != len(want):
            t = min(len(got), len(want))
        if t is None:
            firsts.append(None)
            continue
        margin = sampler_margin(torch, ref[t, i], samplings[i], t) \
            if t < ref.shape[0] else None
        firsts.append([t, margin])
        if margin is None or margin > 2 * bound:
            fail(f"kvtier-tp {name}: stream {i} parts from the tp = 2 twin at token {t} "
                 f"where the twin's sampler margin {margin} exceeds twice the bound")
    row["first_divergence"] = firsts
    log(f"kvtier-tp {name}: {json.dumps(row)}")
    return row


def kvtier_tp_peer_main(seed, kv_cache_dtype, kv_url, model, device):
    """The second process of the kvtier-tp phase: a fresh tp = 2 engine on the
    same cache server; on a line from stdin it restores the 4 streams'
    prefix from the remote tier and serves them (round 4). Prints
    ``kvtier-tp-peer ready``, then one ``kvtier-tp-peer {json}`` line."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.ops import paged_attention as pa

    out = {}

    async def run():
        loop = asyncio.get_running_loop()
        t0 = time.monotonic()
        engine = ServingEngine(EngineConfig(**kvtier_tp_config(
            kv_cache_dtype, seed, TP, model, device, kv_remote_url=kv_url)))
        gate = gate_schedule(engine)
        await engine.start()
        out["engine_up_s"] = time.monotonic() - t0
        print("kvtier-tp-peer ready", flush=True)
        await loop.run_in_executor(None, sys.stdin.readline)
        try:
            out["tokens"], out["row"] = await kvtier_tp_round(
                pa, engine, gate, kvtier_prompts(seed),
                [SamplingParams(max_tokens=KVTIER_TP_TOKENS, ignore_eos=True, **s)
                 for s in KVTIER_TP_SAMPLINGS],
                f"{kv_cache_dtype} remote restore, a fresh tp = {TP} engine")
        finally:
            await engine.stop()
            engine.shutdown()

    asyncio.run(run())
    print("kvtier-tp-peer " + json.dumps(out), flush=True)


def kvtier_tp_pair(pa, pd, model, n_layers, prompts, kv_cache_dtype, name):
    """The 4 streams over both hops of the pair ``launch.py`` started (a tp =
    2 prefill engine, a tp = 1 decode engine), concurrently, as the router
    drives them: POST /disagg/prefill (completions), then the stream from
    the decode engine with the transfer key. Returns (tokens per stream,
    the decode engine's launches, a row)."""
    pre, dec = pd.urls
    request("POST", dec + "/debug/kernels/reset")
    d0 = json.loads(request("GET", dec + "/debug/kernels")[2])["stats"]
    p0 = json.loads(request("GET", pre + "/debug/kernels")[2])["stats"]
    rows = [None] * len(prompts)

    def one(i):
        body = {"model": model, "prompt": prompts[i], "max_tokens": KVTIER_TP_TOKENS,
                "ignore_eos": True, "stream": True, **KVTIER_TP_SAMPLINGS[i]}
        key = f"pstpu-transfer:kvtier-tp-{kv_cache_dtype}-{i}"
        t0 = time.monotonic()
        st, _, text = request("POST", pre + "/disagg/prefill", body, {
            "x-pstpu-transfer-key": key, "x-pstpu-endpoint": "completions",
            "x-request-id": key})
        hop1 = time.monotonic() - t0
        if st != 200 or json.loads(text).get("status") != "handoff":
            rows[i] = {"error": f"hop 1: {st} {text[:300]}"}
            return
        st, chunks, _, tf, te = sse_stream(dec + "/v1/completions", body, {
            "x-pstpu-disagg": "decode", "x-pstpu-transfer-key": key,
            "x-pstpu-resume": "1"})
        rows[i] = {"hop1_s": hop1, "ttft_s": tf - t0, "total_s": te - t0,
                   "tokens": stream_tokens(chunks), "status": st}

    with SmMhz() as clock:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    for i, r in enumerate(rows):
        if r is None or "error" in r or r["status"] != 200:
            fail(f"kvtier-tp {name}: stream {i}: {r}")
    d1 = json.loads(request("GET", dec + "/debug/kernels")[2])
    p1 = json.loads(request("GET", pre + "/debug/kernels")[2])["stats"]
    dstats = d1["stats"]
    steps = dstats["decode_steps_total"] - d0["decode_steps_total"]
    variant = pa.INT8 if kv_cache_dtype == "int8" else pa.BF16
    launches = d1["launch_counts"].get(variant, 0)
    if d1["launch_counts"] and (launches != n_layers * steps or not steps):
        fail(f"kvtier-tp {name}: the decode engine counted {d1['launch_counts']} for "
             f"{steps} decode steps")
    eager = dstats["decode_eager_dispatches_total"] - d0["decode_eager_dispatches_total"]
    if d1["launch_counts"] and eager:
        fail(f"kvtier-tp {name}: {eager} eager decode dispatches on the tp = 1 decode engine")
    if p1["decode_dispatches_total"]:
        fail(f"kvtier-tp {name}: the prefill engine formed "
             f"{p1['decode_dispatches_total']} decode batches")
    for side, s in (("prefill", p1), ("decode", dstats)):
        bad = {k: s[k] for k in ("kv_handoff_failures_total", "kv_spill_failures_total",
                                 "kv_restore_failures_total") if s[k]}
        if bad:
            fail(f"kvtier-tp {name}: {side} engine failure counters {bad}")
    n = len(prompts)
    row = {"ttft_s": [r["ttft_s"] for r in rows], "hop1_s": [r["hop1_s"] for r in rows],
           "decode_steps": steps, "decode_launches": launches,
           "handoff_bytes_per_request": (p1["kv_handoff_bytes_total"]
                                         - p0["kv_handoff_bytes_total"]) / n,
           "handoff_publish_s_per_request": (p1["kv_handoff_seconds_total"]
                                             - p0["kv_handoff_seconds_total"]) / n,
           "prefill_restored_tokens": (p1["kv_restore_saved_tokens_total"]
                                       - p0["kv_restore_saved_tokens_total"]),
           "sm_clock_mhz": clock.summary()}
    log(f"kvtier-tp {name}: {json.dumps(row)}")
    return [r["tokens"] for r in rows], launches, row


def kvtier_tp_phase(torch, pa, device, seed, card, kv_cache_dtype, kv_url, model=TP_MODEL):
    """The KV tier at tp = 2 for one KV dtype (see the module docstring).
    Returns (each tp = 2 rank's launches summed over the tp rounds, the tp =
    1 launches of the cross-mesh rounds, the summary)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.launch import launch_engines
    from production_stack_tpu_torch.models.config import resolve_model_config
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    kv = kv_cache_dtype
    faulthandler.dump_traceback_later(KVTIER_TP_WATCHDOG_S, exit=True)
    cuda = device.type == "cuda"
    mc = resolve_model_config(model)
    out = {"card": card, "kv_cache_dtype": kv, "model": model, "tp": TP}
    tp_launches, tp1_launches = 0, 0
    log_dir = os.path.join(os.path.dirname(DETAIL_LOG), f"kvtier-tp-{kv}")
    os.makedirs(log_dir, exist_ok=True)
    peer_log = open(os.path.join(log_dir, "peer.log"), "w")
    # Round 4's fresh tp = 2 engine warms up in its own process beside this one.
    peer = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--kvtier-tp-peer", kv,
         "--kv-url", kv_url, "--seed", str(seed), "--kvtier-model", model,
         "--kvtier-device", device.type],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=peer_log, text=True)
    prompts = kvtier_prompts(seed)
    samplings = [SamplingParams(max_tokens=KVTIER_TP_TOKENS, ignore_eos=True, **s)
                 for s in KVTIER_TP_SAMPLINGS]
    prompt_ids = None
    rounds = {}
    engine = server = gate = pd = None
    loop = asyncio.new_event_loop()
    pd_holder = {}
    pair = None
    try:
        t_up = time.monotonic()
        engine = ServingEngine(EngineConfig(**kvtier_tp_config(
            kv, seed, TP, model, device.type, kv_remote_url=kv_url, kv_offload_cpu=True)))
        gate = gate_schedule(engine)
        prompt_ids = [engine.tokenizer.encode(p) for p in prompts]

        async def start():
            s = OpenAIServer(engine, "127.0.0.1", 0)
            await s.start()
            return s

        server = loop.run_until_complete(start())
        out["engine_up_s"] = time.monotonic() - t_up

        def rnd(what):
            toks, row = loop.run_until_complete(kvtier_tp_round(
                pa, engine, gate, prompts, samplings, f"{kv} {what}"))
            rounds[what] = row
            return toks

        # 1-3: cold, the device prefix cache (the twin), the host pool
        rnd("cold recompute")
        out["spill_wait_s"] = loop.run_until_complete(
            kvtier_wait_spilled(engine, f"tp {kv}"))
        out["blocks_spilled"] = engine.offload.spilled_blocks_total
        twin = rnd("device prefix cache")
        engine.block_manager.reset_prefix_cache()
        restored = rnd("host-pool restore")
        if restored != twin:
            fail(f"kvtier-tp {kv}: tokens after the host-pool restore differ from the "
                 f"device-cached round's: {[a == b for a, b in zip(restored, twin)]}")
        if rounds["host-pool restore"]["restored_tokens"] <= 0:
            fail(f"kvtier-tp {kv}: the host-pool round restored nothing")
        st, _, text = loop.run_until_complete(loop.run_in_executor(
            None, request, "GET", f"http://127.0.0.1:{server.port}/prefix_index"))
        entries, _ = engine.block_manager.prefix_digest()
        if st != 200 or json.loads(text)["entries"] != entries or not entries:
            fail(f"kvtier-tp {kv}: /prefix_index {st} differs from prefix_digest")
        out["prefix_index_entries"] = len(entries)
        # whole-block reads and writes at tp = 2, and the gloo exchange's share
        blocks = sorted(engine.block_manager._block_to_hash)[:128]
        io0 = engine.mesh.block_io_seconds
        out["link_tp2"] = kvtier_link_rates(torch, engine.runner, blocks)
        # the timed reads and writes' host seconds inside the gloo exchange
        # (the untimed 4-block read before them included)
        out["link_tp2"]["block_exchange_host_s"] = engine.mesh.block_io_seconds - io0
        # the reference: the twin's tokens forced through this engine, its
        # prefix restored from its host pool
        engine.block_manager.reset_prefix_cache()
        t0 = time.monotonic()
        ref, got = loop.run_until_complete(loop.run_in_executor(
            engine._executor, kvtier_forced, torch, engine, prompt_ids, twin,
            KVTIER_TP_TOKENS))
        out["forced_tp2"] = {"seconds": time.monotonic() - t0, "restored_tokens": got}
        if min(got) <= 0:
            fail(f"kvtier-tp {kv}: the forced tp = 2 run restored {got}")
        bound = tp_logit_bound(mc.num_layers, ref.numel())
        st = engine.stats()
        out["stats_tp2"] = {k: st[k] for k in (
            "kv_spilled_blocks_total", "kv_offload_blocks", "prefix_index_size",
            "kv_restore_saved_tokens_total", "kv_shared_tier_hits_total",
            "kv_shared_tier_misses_total", "kv_spill_failures_total",
            "kv_restore_failures_total")}
        reports = loop.run_until_complete(engine.rank_reports())
        out["peak_gib_per_rank"] = [rep["peak_bytes"] / 2**30 for rep in reports]
        loop.run_until_complete(server.stop())
        engine.shutdown()
        tp_launches += sum(sum(r["launches_per_rank"]) for r in rounds.values())
        del engine, server, gate
        engine = server = gate = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # 4: the remote tier, a fresh tp = 2 engine in the peer process
        line = peer.stdout.readline()
        if line.strip() != "kvtier-tp-peer ready":
            fail(f"kvtier-tp {kv}: peer process said {line!r} (exit {peer.poll()})")
        peer.stdin.write("go\n")
        peer.stdin.flush()
        # 5: a fresh tp = 1 engine restores the tp = 2 blobs (built meanwhile)
        t_up = time.monotonic()
        engine = ServingEngine(EngineConfig(**kvtier_tp_config(
            kv, seed, 1, model, device.type, kv_remote_url=kv_url)))
        gate = gate_schedule(engine)
        writes = time_block_writes(torch, engine)
        loop.run_until_complete(engine.start())
        out["engine_up_s_tp1"] = time.monotonic() - t_up
        line = peer.stdout.readline()
        peer.wait(300)
        if not line.startswith("kvtier-tp-peer {") or peer.returncode != 0:
            fail(f"kvtier-tp {kv}: peer process ended {peer.returncode} with {line!r}")
        got = json.loads(line[len("kvtier-tp-peer "):])
        if got["tokens"] != twin:
            fail(f"kvtier-tp {kv}: the remote tier's tokens (a fresh tp = 2 engine) "
                 "differ from the device-cached round's")
        rounds["remote"] = got["row"]
        out["engine_up_s_peer"] = got["engine_up_s"]
        tp_launches += sum(got["row"]["launches_per_rank"])
        if got["row"]["restored_tokens"] <= 0:
            fail(f"kvtier-tp {kv}: the remote round restored nothing")

        # 6: the pair starts while the tp = 1 engine runs round 5
        def start_pair():
            try:
                pd_holder["pd"] = launch_engines(
                    model, 2, engine_args=[*kvtier_tp_server_args(kv, seed),
                                           "--kv-remote-url", kv_url],
                    device=device.type, log_dir=log_dir, startup_timeout_s=600,
                    per_engine_args=[["--role", "prefill", "--tensor-parallel-size",
                                      str(TP), "--no-warmup"], ["--role", "decode"]])
            except BaseException as e:  # noqa: BLE001 — reported by the phase
                pd_holder["error"] = e

        pair = threading.Thread(target=start_pair, daemon=True)
        pair.start()
        t0 = time.monotonic()
        lg1, got = loop.run_until_complete(loop.run_in_executor(
            engine._executor, kvtier_forced, torch, engine, prompt_ids, twin,
            KVTIER_TP_TOKENS))
        out["forced_tp1"] = {"seconds": time.monotonic() - t0, "restored_tokens": got}
        if min(got) <= 0:
            fail(f"kvtier-tp {kv}: the tp = 1 engine restored {got} from the tp = 2 blobs")
        out["cross_tp1_forced"] = kvtier_tp_bar(
            torch, f"{kv} tp = 1 restoring tp = 2 blobs, forced", lg1, ref, [], [],
            KVTIER_TP_SAMPLINGS, bound)
        toks, row = loop.run_until_complete(kvtier_round(
            torch, pa, engine, gate, prompts, samplings,
            f"{kv} tp = 1 restoring tp = 2 blobs", writes))
        rounds["tp1 restore"] = row
        tp1_launches += row["launches"]
        if row["restored_tokens"] <= 0:
            fail(f"kvtier-tp {kv}: the tp = 1 round restored nothing")
        out["cross_tp1_served"] = kvtier_tp_bar(
            torch, f"{kv} tp = 1 restoring tp = 2 blobs, served", None, ref, toks, twin,
            KVTIER_TP_SAMPLINGS, bound)
        out["link_tp1"] = kvtier_link_rates(
            torch, engine.runner, sorted(engine.block_manager._block_to_hash)[:128])
        loop.run_until_complete(engine.stop())
        engine.shutdown()
        del engine, gate, writes
        engine = gate = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        # 6: the prefill (tp = 2) / decode (tp = 1) pair from launch.py
        pair.join(600)
        if "error" in pd_holder or "pd" not in pd_holder:
            fail(f"kvtier-tp {kv}: the prefill/decode pair did not start: "
                 f"{pd_holder.get('error')}")
        pd = pd_holder["pd"]
        out["pair_up_s"] = pd.ready_seconds
        toks, n, out["pair"] = kvtier_tp_pair(pa, pd, model, mc.num_layers, prompts, kv,
                                              f"{kv} tp = 2 prefill -> tp = 1 decode")
        tp1_launches += n
        out["pair"]["bar"] = kvtier_tp_bar(
            torch, f"{kv} tp = 2 prefill -> tp = 1 decode", None, ref, toks, twin,
            KVTIER_TP_SAMPLINGS, bound)
        out["rounds"] = rounds
        out["ttft_s"] = {k: sum(v["ttft_s"]) / len(v["ttft_s"]) for k, v in rounds.items()}
        out["ttft_s"]["pair"] = sum(out["pair"]["ttft_s"]) / len(out["pair"]["ttft_s"])
    finally:
        if peer.poll() is None:
            peer.kill()
            peer.wait()
        if pair is not None:
            pair.join(600)
        if "pd" in pd_holder:
            pd_holder["pd"].stop()
        if server is not None:
            loop.run_until_complete(server.stop())
        if engine is not None:
            engine.shutdown()
        loop.close()
        peer_log.close()
        faulthandler.cancel_dump_traceback_later()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["launches_tp2_ranks"] = tp_launches
    out["launches_tp1"] = tp1_launches
    log(f"kvtier-tp result {json.dumps(out)}")
    return tp_launches, tp1_launches, out


# -------------------------------------------------- phase 9c: kvtier-native
NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def build_native_kv_server(build_dir=None):
    """Build ``native/kv_server.cpp``'s binary from that file alone: ``make
    -C native BUILD=build_dir`` (a fresh temporary directory by default, so
    the checkout gains no ``native/build``, which every default
    ``launch_kv_server`` would then run), or, where there is no ``make``,
    the Makefile's own compiler line. Returns (the binary's path, seconds,
    the command). Raises RuntimeError when it cannot."""
    build_dir = os.path.abspath(build_dir
                                or tempfile.mkdtemp(prefix="kv-native-"))
    t0 = time.monotonic()
    if shutil.which("make"):
        cmd = ["make", "-C", NATIVE_DIR, f"BUILD={build_dir}"]
    else:
        with open(os.path.join(NATIVE_DIR, "Makefile")) as f:
            flags = dict(ln.split(" ?= ", 1) for ln in f.read().splitlines()
                         if " ?= " in ln)
        os.makedirs(build_dir, exist_ok=True)
        cmd = [flags["CXX"].strip(), *flags["CXXFLAGS"].split(), "-o",
               os.path.join(build_dir, "kv_server"),
               os.path.join(NATIVE_DIR, "kv_server.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native kv_server: {cmd[0]} did not run: {e}") from e
    path = os.path.join(build_dir, "kv_server")
    if proc.returncode != 0 or not os.access(path, os.X_OK):
        raise RuntimeError(f"native kv_server: {' '.join(cmd)} exited "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    return path, time.monotonic() - t0, " ".join(cmd)


def is_native_core(url) -> bool:
    """Whether the cache server at ``url`` is the native core: it answers a
    multi-get ('M') with STATUS_ERROR and its stats name no ``impl``."""
    from production_stack_tpu_torch.kv_offload.remote import RemoteKVClient
    from production_stack_tpu_torch.kv_offload.server import (
        STATUS_ERROR,
        pack_key_list,
    )

    c = RemoteKVClient(url)
    try:
        status, _ = c._request(b"M", b"", pack_key_list([b"probe"]))
        return status == STATUS_ERROR and "impl" not in c.stats()
    finally:
        c.close()


def kvtier_native_phase(torch, pa, device, seed, card, model="llama-3b"):
    """The native cache-server core behind the port's server: build the
    binary (``build_native_kv_server``, into a temporary directory), then
    start the Python server (``--force-python``) and the port's server,
    which finds the binary on ``PATH`` and runs it, in turn; against each, one engine
    (``kvtier_config``, bf16 KV, no host pool: the remote tier is its only
    tier) serves the kvtier phase's 4 prompts cold (they spill), drops its
    device prefix cache and serves them again, restored from the remote
    tier. Bars: the second server is the native core (``is_native_core``);
    each restore round restored tokens; the restored rounds' tokens, and
    the stored blobs of every prompt's full blocks, are equal across the
    two servers; the kvtier rounds' own bars (no eager decode dispatch,
    the kernel's count, no tier failure). Returns (the kernel launches of
    its rounds, the summary)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.launch import launch_kv_server

    try:
        binary, build_s, cmd = build_native_kv_server()
    except RuntimeError as e:
        fail(str(e))
    out = {"card": card, "build_s": build_s, "build": cmd, "servers": {}}
    prompts = kvtier_prompts(seed)
    samplings = kvtier_samplings(SamplingParams, KVTIER_TOKENS)
    launches = 0
    got = {}
    path = os.environ.get("PATH", "")
    for name in ("python", "native"):
        # The native round finds the binary on PATH, as an installed one.
        os.environ["PATH"] = (os.path.dirname(binary) + os.pathsep + path
                              if name == "native" else path)
        try:
            server = launch_kv_server(max_bytes=16 << 30,
                                      log_dir=os.path.dirname(DETAIL_LOG),
                                      force_python=name == "python")
        finally:
            os.environ["PATH"] = path
        loop = asyncio.new_event_loop()
        engine = None
        try:
            if is_native_core(server.url) != (name == "native"):
                fail(f"kvtier native: the {name} round's server at {server.url} "
                     f"is{' not' if name == 'native' else ''} the native core "
                     f"(binary {binary})")
            t0 = time.monotonic()
            engine = ServingEngine(EngineConfig(**kvtier_config(
                "bfloat16", seed, model, device.type, kv_remote_url=server.url)))
            gate = gate_schedule(engine)
            writes = time_block_writes(torch, engine)
            loop.run_until_complete(engine.start())
            up = time.monotonic() - t0
            rows = {}
            _, rows["cold"] = loop.run_until_complete(kvtier_round(
                torch, pa, engine, gate, prompts, samplings,
                f"native {name} cold recompute", writes))
            spill_s = loop.run_until_complete(
                kvtier_wait_spilled(engine, f"native {name}"))
            engine.block_manager.reset_prefix_cache()
            toks, rows["restore"] = loop.run_until_complete(kvtier_round(
                torch, pa, engine, gate, prompts, samplings,
                f"native {name} remote restore", writes))
            if rows["restore"]["restored_tokens"] <= 0:
                fail(f"kvtier native: the {name} server's round restored nothing")
            bs = engine.config.block_size
            ids = [engine.tokenizer.encode(p) for p in prompts]
            # The stored bytes (PKC1 envelopes), by per-key gets: every
            # server answers them.
            blobs = [[engine.offload.remote.get(k) for k in
                      kvtier_store_keys(engine, t, (len(t) - 1) // bs)]
                     for t in ids]
            if any(b is None for bl in blobs for b in bl):
                fail(f"kvtier native: the {name} server lacks a spilled block")
            loop.run_until_complete(engine.stop())
            launches += sum(r["launches"] for r in rows.values())
            got[name] = (toks, blobs)
            out["servers"][name] = {
                "engine_up_s": up, "spill_wait_s": spill_s,
                "ttft_s": {k: sum(r["ttft_s"]) / len(r["ttft_s"])
                           for k, r in rows.items()},
                "restore_s": rows["restore"]["restore_s"],
                "restored_tokens": rows["restore"]["restored_tokens"],
                "blobs": sum(len(b) for b in blobs),
                "blob_bytes": sum(len(x) for b in blobs for x in b),
                "stats": kv_server_stats(server.url),
                "sm_clock_mhz": {k: r["sm_clock_mhz"]["mean"]
                                 if isinstance(r["sm_clock_mhz"], dict) else None
                                 for k, r in rows.items()}}
        finally:
            if engine is not None:
                engine.shutdown()
            loop.close()
            out["servers"].setdefault(name, {})["exit_code"] = server.stop()
        del engine
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    (pt, pb), (nt, nb) = got["python"], got["native"]
    if nt != pt:
        fail(f"kvtier native: restored tokens differ from the Python server's "
             f"round's: {[a == b for a, b in zip(nt, pt)]}")
    if nb != pb:
        fail("kvtier native: the native core's stored blobs differ from the "
             "Python server's for the same prompts")
    out["tokens_equal"] = out["blobs_equal"] = True
    log(f"kvtier native result {json.dumps(out)}")
    return launches, out


def kv_server_stats(url) -> dict:
    """A cache server's 'T' stats."""
    from production_stack_tpu_torch.kv_offload.remote import RemoteKVClient

    c = RemoteKVClient(url)
    try:
        return c.stats()
    finally:
        c.close()


# ---------------------------------------------------------------- phase 10
SPEC_N = 4                  # draft-ahead tokens
SPEC_TOKENS = 64            # tokens per request
# The ingest rounds' heads, two per catch-up bucket 16, 32, 128 and 256
# (ByteTokenizer: a token per byte; their full blocks of 16 are cached),
# and tokens per stream.
SPEC_INGEST_HEADS = (20, 40, 100, 250, 24, 44, 110, 260)
SPEC_INGEST_TOKENS = 16
# Tokens per request of the profiled round of each pair's off and linear
# modes: the host processes every profiler record, so the round's time
# grows with the tokens it traces. The checks keep SPEC_TOKENS.
SPEC_TRACE_TOKENS = 16
# (pair, target, draft): the ceiling (a self-draft accepts nearly
# everything) and the floor (a random llama-3b drafting for a random
# llama-3-8b accepts nearly nothing).
SPEC_PAIRS = (("self", "llama-3b", "llama-3b"),
              ("cross", "llama-3-8b", "llama-3b"))
SPEC_MODES = (("off", {}),
              ("linear", {"speculative_num_tokens": SPEC_N}),
              ("tree", {"speculative_num_tokens": SPEC_N,
                        "speculative_tree_width": 3}),
              ("adaptive", {"speculative_num_tokens": SPEC_N,
                            "speculative_adaptive": True}))
# Seeded streams sample unfiltered: their pick is the argmax of logits / T
# plus the row's Gumbel field, so the token bar's margin is exact (a top-p
# or top-k set has an edge a logit change can move as well; the float32
# identity below covers filtered sampling bit for bit).
SPEC_SAMPLINGS = ({"temperature": 0.0}, {"temperature": 0.0},
                  {"temperature": 0.8, "seed": 1234},
                  {"temperature": 0.7, "seed": 7})
SPEC_SERIES = ("pstpu:spec_enabled", "pstpu:spec_draft_tokens_total",
               "pstpu:spec_accepted_tokens_total", "pstpu:spec_acceptance_rate",
               "pstpu:spec_acceptance_rate_window", "pstpu:spec_draft_depth",
               "pstpu:spec_tree_nodes_total", "pstpu:spec_acceptance_ema",
               "pstpu:spec_gamma0_dispatches_total")


def spec_prompts(seed: int):
    """4 prompts of ~90-120 ByteTokenizer tokens: with the phases' prefill
    budget (``WARM_PREFILL_BUDGET``) one prefill dispatch takes all four
    whole, so the rows decode in lockstep."""
    rng = random.Random(seed + 8)
    words = ("a draft proposes tokens and the target verifies them in one "
             "forward while the scheduler keeps every stream on the card").split()
    out = []
    for i in range(4):
        text = []
        while sum(len(w) + 1 for w in text) < 90 + 8 * i:
            text.append(rng.choice(words))
        out.append(" ".join(text)[:118])
    return out


def spec_config(target, draft, fields, seed, device="cuda", **over):
    """One engine of the spec phase: bf16 weights and KV, block 16, 1024
    blocks, 4 rows (the decode families of 1, 2 and 4 rows), graphs
    captured at warm-up; speculation per ``fields`` (the draft named only
    when on)."""
    from production_stack_tpu_torch.engine.config import EngineConfig

    fields = {**({"speculative_model": draft} if fields else {}), **fields}
    return EngineConfig(**{
        "model": target, "dtype": "bfloat16", "device": device,
        "max_model_len": 2048, "block_size": 16, "num_kv_blocks": 1024,
        "max_num_seqs": 4, "num_decode_steps": 32, "seed": seed,
        "max_num_batched_tokens": WARM_PREFILL_BUDGET,
        "enable_warmup": True, **fields, **over})


def spec_http_round(torch, pa, engine, gate, prompts, what):
    """The 4 requests (2 greedy, 2 seeded, streamed completions with the
    pstpu payload) behind the port's server, held until all 4 wait so they
    form one prefill batch; then /metrics. Returns (token ids per stream,
    a row of numbers, the stats, the exposition)."""
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    r = engine.runner
    out = {}

    async def run():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        for key in ("decode_steps_total", "decode_tokens_total",
                    "decode_seconds_total", "decode_device_seconds_total",
                    "prefill_seconds_total"):
            setattr(r, key, 0)
        engine.decode_dispatches_total = engine.prefill_dispatches_total = 0
        train = r.decode_train
        eager0, graph0 = train.eager_dispatches_total, train.graph_dispatches_total
        st0 = engine.stats()
        if r.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
        gate["want"] = 4
        t0 = time.monotonic()

        def one(i):
            body = {"prompt": prompts[i], "max_tokens": SPEC_TOKENS,
                    "stream": True, "ignore_eos": True, **SPEC_SAMPLINGS[i]}
            t = time.monotonic()
            st, evs, t_first, t_end = http("POST", base + "/v1/completions",
                                           body, True,
                                           headers={"x-pstpu-resume": "1"})
            if st != 200 or evs[-1] != "[DONE]":
                fail(f"spec {what}: request {i}: HTTP {st}")
            toks = [t for e in evs[:-1] for t in e.get("pstpu", {}).get("toks", [])]
            return toks, t_first - t

        with SmMhz() as clock:
            res = await asyncio.gather(*[loop.run_in_executor(None, one, i)
                                         for i in range(4)])
        wall = time.monotonic() - t0
        stats = engine.stats()
        out["launches"] = pa.launch_counts()
        st, _, text = await loop.run_in_executor(
            None, request, "GET", base + "/metrics")
        if st != 200:
            fail(f"spec {what}: /metrics HTTP {st}")
        out.update(res=res, wall=wall, clock=clock.summary(), stats=stats,
                   st0=st0, text=text,
                   eager=train.eager_dispatches_total - eager0,
                   graph=train.graph_dispatches_total - graph0,
                   peak=(torch.cuda.max_memory_allocated() / 2**30
                         if r.device.type == "cuda" else None))
        await server.stop()

    asyncio.run(run())
    toks = [t for t, _ in out["res"]]
    for i, t in enumerate(toks):
        if len(t) != SPEC_TOKENS:
            fail(f"spec {what}: stream {i} gave {len(t)} tokens")
    st, st0 = out["stats"], out["st0"]
    if r.device.type == "cuda" and (out["eager"] or not out["graph"]):
        fail(f"spec {what}: {out['eager']} eager decode dispatches after "
             f"warm-up ({out['graph']} replayed)")
    # /metrics against stats(): the spec series read the runner's counters
    # (gauges rendered to 6 significant digits).
    series = parse_metrics(out["text"])
    for name in SPEC_SERIES:
        got = series.get(name)
        want = float(st[name.split(":")[1]])
        if not got or abs(got[0][1] - want) > 1e-5 * max(1.0, abs(want)):
            fail(f"spec {what}: /metrics {name} {got} != stats() {want}")
    d = lambda k: st[k] - st0[k]  # noqa: E731
    dispatches = st["decode_dispatches_total"]
    emitted = st["decode_tokens_total"]
    dev_s = st["decode_device_seconds_total"]
    live = d("spec_live_cycles_total")
    row = {
        "wall_s": out["wall"], "aggregate_tok_s": 4 * SPEC_TOKENS / out["wall"],
        "ttft_s": [f for _, f in out["res"]],
        "decode_dispatches": dispatches, "decode_tokens": emitted,
        "ms_per_dispatch_events": 1e3 * dev_s / dispatches if dispatches else None,
        "ms_per_token_events": 1e3 * dev_s / emitted if emitted else None,
        # a stream's cadence: the 4 rows decode together
        "ms_per_row_token_events": (1e3 * dev_s * len(toks) / emitted
                                    if emitted else None),
        "decode_steps": st["decode_steps_total"],
        "drafts": d("spec_draft_tokens_total"),
        "accepted": d("spec_accepted_tokens_total"),
        "acceptance": (d("spec_accepted_tokens_total")
                       / d("spec_draft_tokens_total")
                       if d("spec_draft_tokens_total") else None),
        "draft_depth_mean": (d("spec_draft_tokens_total") / live
                             if live else None),
        "tokens_per_target_step": emitted / live if live else 1.0,
        "cycles_run": d("spec_cycles_run_total"),
        "cycles_live": d("spec_cycles_live_total"),
        "gamma0_dispatches": d("spec_gamma0_dispatches_total"),
        "graph_families": st["graph_families"],
        "graph_families_spec": st["graph_families_spec"],
        "graphs_captured": st["graphs_captured"],
        "graph_spec_nodes_max": st["graph_spec_nodes_max"],
        "graph_capture_seconds": st["graph_capture_seconds"],
        "graph_pool_bytes": st["graph_pool_bytes"],
        "spec_pool_bytes": st["spec_pool_bytes"],
        # the draft-ingest buckets warm-up captured, and their seconds
        "ingest_buckets": st["spec_ingest_graph_buckets"],
        "ingest_capture_seconds": st["spec_ingest_capture_seconds"],
        "ingest_warm_seconds": st["spec_ingest_warm_seconds"],
        "warmup_s": st["startup_warmup_seconds"],
        "peak_mem_gib": out["peak"], "sm_clock_mhz": out["clock"],
        "launches": out["launches"],
    }
    log(f"spec {what}: {json.dumps(row)}")
    return toks, row, st


def spec_api_round(engine, gate, prompts, eager=False, sink=None,
                   n_tokens=SPEC_TOKENS):
    """The 4 requests on the engine API, held by ``gate`` until all wait
    (one prefill batch), in one event loop with the engine started and
    stopped inside it (an engine left running in a closed loop hangs the
    next round; the HTTP round's server stopped it). After the warm-up,
    ``eager`` sets the graphs aside and ``sink`` keeps every dispatch
    step's logits. Returns each stream's tokens."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    r = engine.runner
    saved = r.decode_train.graphs, r.prefill_train.graphs, r.ingest_train.graphs

    async def run():
        await engine.start()
        if eager:
            r.decode_train.graphs = r.prefill_train.graphs = {}
            r.ingest_train.graphs = {}
        r.logits_sink = sink
        gate["want"] = 4

        async def one(i):
            last = None
            async for o in engine.generate(prompt=prompts[i], sampling=SamplingParams(
                    max_tokens=n_tokens, ignore_eos=True, **SPEC_SAMPLINGS[i])):
                last = o
            return last.token_ids

        try:
            return await asyncio.gather(*[one(i) for i in range(4)])
        finally:
            await engine.stop()

    try:
        return asyncio.run(run())
    finally:
        r.decode_train.graphs, r.prefill_train.graphs, r.ingest_train.graphs = saved
        r.logits_sink = None


def spec_eager_logits(torch, engine, gate, prompts, what):
    """The same 4 requests through the strict eager loop, cold as the HTTP
    round was (the same prefill batch), every decode step's full f32
    logits kept: (tokens per stream, sampler margin per stream and token
    index). Rows run in lockstep (one prefill batch; each decode dispatch
    takes all 4), so sink entry t holds token t's logits (0: the
    prefill's)."""
    engine.block_manager.reset_prefix_cache()
    sink = []
    toks = spec_api_round(engine, gate, prompts, eager=True, sink=sink)
    margins = [[sampler_margin(torch, sink[t][i].float(), SPEC_SAMPLINGS[i], t)
                for t in range(SPEC_TOKENS)] for i in range(4)]
    log(f"spec {what}: eager logits of {len(sink)} dispatch steps kept; "
        f"margins under 0.05 per stream: "
        f"{[sum(m < 0.05 for m in row) for row in margins]}")
    return toks, margins


def sampler_margin(torch, logits, sampling, gen):
    """In logit units, how far the sampler's pick at generation index
    ``gen`` stands above the runner-up: the top-2 gap of the raw logits for
    a greedy row; of the field an unfiltered seeded row takes its argmax of
    (logits / T + the row's Gumbel field), times T. A logit change smaller
    than half of it cannot change the pick."""
    from production_stack_tpu_torch.engine.sampling import gumbel_noise, token_seed

    temp = sampling.get("temperature", 1.0)
    if temp <= 0.0:
        top2 = torch.topk(logits, 2).values
        return float(top2[0] - top2[1])
    g = gumbel_noise([token_seed(sampling["seed"], gen)], logits.shape[-1],
                     logits.device)[0]
    top2 = torch.topk(logits / temp + g, 2).values
    return float((top2[0] - top2[1]) * temp)


def spec_graph_vs_eager(engine, gate, prompts, what):
    """Graph replays against the strict eager train on the engine API, on
    the same batches (both rounds find the same prefix-cache state): tokens
    bit for bit."""
    runs = {mode: spec_api_round(engine, gate, prompts, eager=mode == "eager")
            for mode in ("graph", "eager")}
    if runs["graph"] != runs["eager"]:
        bad = [i for i in range(4) if runs["graph"][i] != runs["eager"][i]]
        fail(f"spec {what}: graph replay tokens differ from the strict eager "
             f"train on streams {bad}")
    return True


def spec_fresh_rings(torch, r):
    """Every draft ring as a start leaves it (K and V zero, no position
    written) and every slot free, so two rounds find equal rings and take
    the same slots. The engine is idle."""
    from production_stack_tpu_torch.engine.decode_graphs import POS_SENTINEL

    if r.device.type == "cuda":
        torch.cuda.synchronize()
    r.spec_k.zero_()
    r.spec_v.zero_()
    r.spec_pos.fill_(POS_SENTINEL)
    r._spec_slots.clear()
    r._spec_warmed.clear()
    r._spec_free = list(range(r.spec_num_slots))


def spec_ingest_rounds(torch, engine, prompts, what):
    """The draft's catch-up on the card, the graph round first and then its
    strict eager twin (every decode, prefill and ingest graph set aside),
    each in one start: the heads (``SPEC_INGEST_HEADS`` tokens of the
    prompts, in turn) served one at a time with graphs, so their blocks are
    cached; then, from fresh rings, a greedy stream of
    ``SPEC_INGEST_TOKENS`` over each head and a tail, one at a time: each
    prefill finds its head cached and catches its draft ring up over it.
    Bars: in the graph round every catch-up replayed
    (``spec_ingest_eager_total`` unchanged) and ``spec_ingests`` grew by
    one per stream; its tokens and draft-ring digest equal the twin's bit
    for bit; the twin's catch-ups ran eagerly. Returns the host ms per
    catch-up by bucket, replayed and eager, and the counts."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    r = engine.runner
    train = r.ingest_train
    heads = [((prompts[i % len(prompts)] + " ") * 4)[:n]
             for i, n in enumerate(SPEC_INGEST_HEADS)]
    runs = {}

    async def one(prompt, n):
        last = None
        async for o in engine.generate(prompt=prompt, sampling=SamplingParams(
                max_tokens=n, ignore_eos=True, temperature=0.0)):
            last = o
        return last

    for mode in ("graph", "eager"):
        saved = r.decode_train.graphs, r.prefill_train.graphs, train.graphs

        async def run():
            await engine.start()
            try:
                engine.block_manager.reset_prefix_cache()
                for h in heads:
                    await one(h, 1)
                if mode == "eager":
                    r.decode_train.graphs = r.prefill_train.graphs = {}
                    train.graphs = {}
                spec_fresh_rings(torch, r)
                c0 = (r.spec_ingests_total, train.eager_dispatches_total,
                      train.graph_dispatches_total)
                host0 = {t: list(v) for t, v in train.host_by_bucket.items()}
                outs = [await one(h + " and the stream goes on past its head",
                                  SPEC_INGEST_TOKENS) for h in heads]
                host = {t: 1e3 * (s - host0.get(t, [0, 0.0])[1])
                        / (n - host0.get(t, [0, 0.0])[0])
                        for t, (n, s) in train.host_by_bucket.items()
                        if n > host0.get(t, [0, 0.0])[0]}
                if r.device.type == "cuda":
                    torch.cuda.synchronize()
                return {"tokens": [o.token_ids for o in outs],
                        "cached": [o.num_cached_tokens for o in outs],
                        "digest": r.spec_digest(),
                        "ingests": r.spec_ingests_total - c0[0],
                        "eager": train.eager_dispatches_total - c0[1],
                        "replayed": train.graph_dispatches_total - c0[2],
                        "host_ms_by_bucket": host}
            finally:
                r.decode_train.graphs, r.prefill_train.graphs, train.graphs = saved
                await engine.stop()

        runs[mode] = asyncio.run(run())
    g, e = runs["graph"], runs["eager"]
    log(f"spec {what} ingest rounds: {json.dumps(runs)}")
    if g["ingests"] != len(heads) or not all(g["cached"]):
        fail(f"spec {what}: the ingest round ran {g['ingests']} catch-ups over "
             f"cached heads of {g['cached']} tokens")
    if r.device.type == "cuda" and (g["eager"] or g["replayed"] != len(heads)
                                    or e["eager"] != len(heads)):
        fail(f"spec {what}: the graph round's catch-ups: {g['eager']} eager, "
             f"{g['replayed']} replayed; the twin's: {e['eager']} eager")
    if g["tokens"] != e["tokens"] or g["digest"] != e["digest"]:
        fail(f"spec {what}: after the catch-ups the graph round's tokens "
             f"(equal: {[a == b for a, b in zip(g['tokens'], e['tokens'])]}) or "
             f"draft-ring digest ({g['digest']} / {e['digest']}) differ from the "
             "strict eager twin's")
    return {"host_ms_by_bucket": {"replayed": g["host_ms_by_bucket"],
                                  "eager": e["host_ms_by_bucket"]},
            "cached_tokens": g["cached"], "ingests": g["ingests"],
            "replayed": g["replayed"], "eager_twin": e["eager"],
            "tokens_and_rings_equal_eager": True}


def spec_trace(torch, engine, gate, prompts, what):
    """One engine-API round of the 4 requests under torch.profiler (graph
    replays): busy share, device ms by kernel class, the top kernels."""
    tr = trace_requests(
        torch, lambda n: spec_api_round(engine, gate, prompts, n_tokens=n),
        SPEC_TRACE_TOKENS)
    log(f"spec {what} trace {json.dumps(tr)}")
    return {k: tr[k] for k in ("wall_s", "device_busy_s", "busy_share",
                               "ms_by_class", "top_ms")}


def spec_token_bar(on, off, margins, bound):
    """Tokens of a spec-on round equal spec-off's up to the first index
    where spec-off's sampler margin (``sampler_margin``) is under
    ``bound``: returns (each stream's first divergence index or None, and
    the margin there; whether the bar holds)."""
    firsts, ok = [], True
    for i in range(4):
        t = next((t for t in range(len(off[i])) if on[i][t] != off[i][t]), None)
        firsts.append(None if t is None else [t, margins[i][t]])
        if t is not None and all(m >= bound for m in margins[i][:t + 1]):
            ok = False
    return firsts, ok


class Laps(dict):
    """Wall seconds per named step, each from the end of the one before."""

    def __init__(self):
        super().__init__()
        self.t = time.monotonic()

    def __call__(self, step: str) -> None:
        now = time.monotonic()
        self[step] = now - self.t
        self.t = now


def spec_phase(torch, pa, device, seed, card, pairs=SPEC_PAIRS):
    """Speculative decoding at full width, both pairs (their depth as
    ``pairs`` gives it: ``cut_model``'s directories in the full run), four
    modes each behind the HTTP server; returns the summary."""
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.models import get_model_fns
    from production_stack_tpu_torch.models.config import resolve_model_config

    prompts = spec_prompts(seed)
    out = {"card": card, "n": SPEC_N, "tokens": SPEC_TOKENS, "pairs": {}}
    launches_off = 0
    for pair, target, draft in pairs:
        mc, dmc = resolve_model_config(target), resolve_model_config(draft)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        t0 = time.monotonic()
        params = get_model_fns(mc)[0](mc, gen, torch.bfloat16, device)
        draft_params = None
        if draft != target:
            gen.manual_seed(seed + 1)
            draft_params = get_model_fns(dmc)[0](dmc, gen, torch.bfloat16, device)
        log(f"spec {pair}: {target} <- {draft} weights in "
            f"{time.monotonic() - t0:.1f} s")
        bound = 2 * tp_logit_bound(mc.num_layers, 4 * SPEC_TOKENS)
        rows, off = {}, None
        for mode, fields in SPEC_MODES:
            what = f"{pair} {mode}"
            lap = Laps()
            engine = ServingEngine(spec_config(target, draft, fields, seed,
                                               device=device.type),
                                   params=params, draft_params=draft_params)
            lap("up")
            gate = gate_schedule(engine)
            toks, row, st = spec_http_round(torch, pa, engine, gate, prompts,
                                            what)
            lap("served")
            row["engine_up_s"] = lap["up"]
            row["step_s"] = lap
            row["attn_impl"] = st["attn_impl"]
            if mode == "off":
                off = toks
                eager_toks, margins = spec_eager_logits(torch, engine, gate,
                                                        prompts, what)
                lap("eager_logits")
                row["eager_equal_graph"] = eager_toks == toks
                if not row["eager_equal_graph"]:
                    fail(f"spec {what}: strict eager tokens differ from the "
                         "graph round's")
                # The paged kernel, exactly once per layer and decode step
                # (spec-off resolves to it on the card).
                n, steps = row["launches"][pa.BF16], st["decode_steps_total"]
                if device.type == "cuda" and (
                        engine.runner.attn_impl != "paged"
                        or n != mc.num_layers * steps or not steps):
                    fail(f"spec {what}: {n} paged-kernel launches over "
                         f"{steps} decode steps of {mc.num_layers} layers "
                         f"(attn {engine.runner.attn_impl})")
                launches_off += n
            else:
                first, ok = spec_token_bar(toks, off, margins, bound)
                row["first_divergence"] = first
                row["margin_bound"] = bound
                if not ok:
                    fail(f"spec {what}: tokens part from spec-off at "
                         f"{first} ([index, margin] per stream) where every "
                         f"spec-off margin up to it is at least {bound:.4f}")
                # Eager rejection-path rounds are slow at 8b (63 cycles):
                # the cross pair holds its linear mode to strict eager.
                if pair == "self" or mode == "linear":
                    row["graph_equal_eager"] = spec_graph_vs_eager(
                        engine, gate, prompts, what)
                    lap("graph_vs_eager")
                if pair == "self" and mode == "linear":
                    row["ingest"] = spec_ingest_rounds(torch, engine, prompts,
                                                       what)
                    lap("ingest")
                if st["spec_draft_tokens_total"] <= 0 and mode != "adaptive":
                    fail(f"spec {what}: no draft proposals counted")
            # Profiled rounds of the self pair only: the cross pair's would
            # add 7-10 s to the script's time limit.
            if pair == "self" and mode in ("off", "linear") and device.type == "cuda":
                row["trace"] = spec_trace(torch, engine, gate, prompts, what)
                lap("trace")
            rows[mode] = row
            engine.shutdown()
            del engine
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            lap("down")
            log(f"spec {what} step seconds {json.dumps(lap)}")
        out["pairs"][pair] = {"target": target, "draft": draft, "modes": rows}
        del params, draft_params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return launches_off, out


def spec_f32_identity(torch, pa, device, seed):
    """float32 on the card, tiny-llama with the tiny-llama self-draft and
    the tiny-opt cross draft: the four modes' tokens equal spec-off's bit
    for bit, greedy, seeded and seeded with top-p / top-k, graphs
    captured. Requests run one at a time, so each engine takes one row
    (its warm-up captures the 1-row families alone). Spec-off decodes
    through the paged kernels (the generic float32 variant: head dim 32),
    its count layers x decode steps; speculation runs on the window path.
    Returns (spec-off's launches, a row)."""
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    prompts = ["four mode parity on the card", "a second stream"]
    sps = [SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True),
           SamplingParams(temperature=0.9, seed=1234, max_tokens=24,
                          ignore_eos=True),
           SamplingParams(temperature=0.8, top_p=0.9, top_k=50, seed=5,
                          max_tokens=24, ignore_eos=True)]

    def serve(fields, draft):
        cfg = spec_config("tiny-llama", draft, fields, seed, device=device.type,
                          dtype="float32", max_model_len=256, num_kv_blocks=128,
                          num_decode_steps=8, max_num_seqs=1)
        engine = ServingEngine(cfg)

        async def run():
            await engine.start()
            pa.reset_launch_counts()
            steps0 = engine.runner.decode_steps_total
            got = []
            for p in prompts:
                for sp in sps:
                    last = None
                    async for o in engine.generate(prompt=p, sampling=sp):
                        last = o
                    got.append(last.token_ids)
            st = engine.stats()
            st["launches"] = pa.launch_counts()
            st["steps"] = engine.runner.decode_steps_total - steps0
            st["layers"] = engine.model_config.num_layers
            st["variant"] = (engine_variant(pa, engine)
                             if engine.runner.attn_impl == "paged" else None)
            await engine.stop()
            return got, st

        got, st = asyncio.run(run())
        engine.shutdown()
        # Its runner and trains hold each other: collect them (and their
        # graphs) before the next engine captures, as the spec phase does.
        del engine
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return got, st

    off, st = serve({}, None)
    variant, launches = st["variant"], st["launches"]
    want = {**dict.fromkeys(pa.VARIANTS, 0), variant: st["layers"] * st["steps"]}
    if device.type == "cuda" and (variant is None or launches != want):
        fail(f"spec f32 spec-off: the paged kernels' counts {launches}, want "
             f"{want} (variant {variant})")
    out = {"off": {"variant": variant, "launches": launches.get(variant, 0),
                   "decode_steps": st["steps"]}}
    for draft in ("tiny-llama", "tiny-opt"):
        for mode, fields in SPEC_MODES[1:]:
            got, st = serve(fields, draft)
            if got != off:
                fail(f"spec f32 {draft} {mode}: tokens differ from spec-off")
            if device.type == "cuda" and st["decode_eager_dispatches_total"]:
                fail(f"spec f32 {draft} {mode}: eager decode dispatches")
            out[f"{draft} {mode}"] = {"equal": True,
                                      "acceptance": st["spec_acceptance_rate"]}
    log(f"spec f32 identity: {json.dumps(out)}")
    return out["off"]["launches"], out


# ------------------------------------------------- phase 11b: opt-tp, spec-dp
OPT_TP_MODEL = "facebook/opt-125m"
OPT_TP_TOKENS = 32                  # greedy tokens per stream, forced and served


def opt_tp_phase(torch, device, seed, card, model=OPT_TP_MODEL):
    """The OPT family at tensor_parallel_size 2: facebook/opt-125m at full
    width and depth (random bf16 weights from ``seed``: every rank draws
    the whole model and keeps its shard), both ranks on this card (gloo,
    host-staged), the window path (the paged kernel is llama-only). The
    eager tp = 1 runner's greedy run of the 4 graph prompts (one prefill,
    then ``OPT_TP_TOKENS`` - 1 one-step decodes) is forced through the tp =
    2 engine's runner: max |logit diff| within ``tp_logit_bound``, argmax
    equal where tp = 1's top-2 margin exceeds twice it; ms per eager
    decode step of both runners (and rank 0's host ms in the gloo
    collectives); then both engines serve the 4 prompts greedily on the
    engine API: each stream equals tp = 1's forced greedy tokens up to the
    first step whose margin is under twice the bound, both ranks sampled
    the same tokens (token digests) and launched no paged kernel. Returns
    the summary."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
    from production_stack_tpu_torch.models.config import resolve_model_config

    mc = resolve_model_config(model)
    name = "opt-tp"
    tok = ByteTokenizer(mc.vocab_size)
    prompt_ids = [tok.encode(p) for p in graph_prompts(seed)]
    # 4 rows of the model's whole context (block 16) + the null block.
    common = dict(model=model, dtype="bfloat16", device=device.type,
                  max_model_len=mc.max_position_embeddings, num_decode_steps=32,
                  seed=seed, num_kv_blocks=4 * mc.max_position_embeddings // 16 + 1,
                  max_num_seqs=4, max_prefill_seqs=4)
    steps = OPT_TP_TOKENS - 1

    t0 = time.monotonic()
    ref = ModelRunner(EngineConfig(**common), mc)
    up1 = time.monotonic() - t0
    if ref.attn_impl != "window":
        fail(f"{name}: the tp = 1 runner took the {ref.attn_impl} path")
    lg1, greedy1, seqs = tp_forced(torch, ref, prompt_ids, None, steps)
    timing1 = tp_decode_timing(torch, ref, seqs, [list(g) for g in greedy1])
    del ref, seqs
    gc.collect()
    torch.cuda.empty_cache()
    engine = ServingEngine(EngineConfig(**common))
    try:
        served1 = sp_serve(engine, prompt_ids, OPT_TP_TOKENS)
    finally:
        engine.shutdown()
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    engine = ServingEngine(EngineConfig(**common, tensor_parallel_size=TP,
                                        tp_timeout_s=TP_TIMEOUT_S))
    up2 = time.monotonic() - t0
    try:
        runner = engine.runner
        coll0 = runner.tp.collective_seconds
        lg2, greedy2, seqs = tp_forced(torch, runner, prompt_ids, greedy1, steps)
        timing2 = tp_decode_timing(torch, runner, seqs, [list(g) for g in greedy2])
        forced_coll_s = runner.tp.collective_seconds - coll0
        served2 = sp_serve(engine, prompt_ids, OPT_TP_TOKENS)
        pool_heads = runner.kv_k.shape[1]
        reports = engine.tp_reports
    finally:
        engine.shutdown()
    del engine, runner, seqs
    gc.collect()
    torch.cuda.empty_cache()
    bound = tp_logit_bound(mc.num_layers, lg1.numel())
    top2 = lg1.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * bound
    same = lg2.argmax(-1) == lg1.argmax(-1)
    if not bool(same[decided].all()):
        fail(f"{name}: argmax differs at a step whose tp = 1 top-2 margin "
             f"exceeds twice the bound ({2 * bound:.4f})")
    bars = sp_bars(torch, name, lg2, lg1, served2["tokens"], greedy1, bound)
    bars_tp1 = sp_bars(torch, f"{name} tp = 1 served", lg1, lg1,
                       served1["tokens"], greedy1, bound)
    after = served2["after"]
    if len({r["token_digest"] for r in after}) != 1 or \
            len({r["token_digest"] for r in reports}) != 1:
        fail(f"{name}: the ranks' token digests differ: {after}")
    if any(any(r["launch_counts"].values()) for r in after):
        fail(f"{name}: a rank launched the paged kernel on the window path: "
             f"{[r['launch_counts'] for r in after]}")
    if pool_heads != mc.num_heads // TP:
        fail(f"{name}: rank 0's pool holds {pool_heads} heads, want "
             f"{mc.num_heads // TP}")
    n_tok = sum(len(t) for t in served2["tokens"])
    out = {
        "card": card, "model": model, "tp": TP, "layers": mc.num_layers,
        "backend": served2["stats"]["tp_backend"],
        "engine_up_s": {"tp1_runner": up1, "tp2": up2},
        "decode_ms_per_step_tp1_eager": timing1,
        "decode_ms_per_step_tp2_eager": timing2,
        "gloo_collective_host_s_forced_run": forced_coll_s,
        "served_ms_per_token": {
            "tp1": 1e3 * served1["wall"] / max(1, n_tok),
            "tp2": 1e3 * served2["wall"] / max(1, n_tok)},
        "served_tokens_equal_tp1": served2["tokens"] == served1["tokens"],
        "logits": {**bars, "steps_checked": int(decided.sum()),
                   "steps": int(decided.numel()),
                   "argmax_equal_all": float(same.float().mean())},
        "first_divergence_tp1_served": bars_tp1["first_divergence"],
        "weight_gib_per_rank": [r["weight_bytes"] / 2**30 for r in after],
        "peak_gib_per_rank": [r["peak_bytes"] / 2**30 for r in after],
    }
    log(f"{name} result {json.dumps(out)}")
    return out


SPEC_DP_MODEL = "llama-3b"
SPEC_DP_TOKENS = 32                # tokens per stream
SPEC_DP_BLOCKS = 512
# (mode, speculative fields), every mode at CUT_LAYERS, so the whole script
# keeps inside its time on slower machines: with linear at llama-3b's full
# depth it took 914 s on an H100 80GB HBM3 at 700 W.
SPEC_DP_MODES = (
    ("linear", {"speculative_num_tokens": SPEC_N}),
    ("tree", {"speculative_num_tokens": SPEC_N, "speculative_tree_width": 3}),
    ("adaptive", {"speculative_num_tokens": SPEC_N,
                  "speculative_adaptive": True}),
    ("off", {}),
)
SPEC_DP_COUNTERS = ("spec_draft_tokens_total", "spec_accepted_tokens_total",
                    "spec_cycles_run_total")


def spec_dp_config(model, fields, seed, device="cuda", **over):
    """One engine of the spec-dp phase: bf16, block 16, 4 rows and prefill
    rows of exactly 4 at dp = 1 too (one prefill batch has one shape on
    every engine), eager (no warm-up graphs: a mesh captures none, and the
    dp = 1 engine must run the same kernels); speculation per ``fields``,
    the model drafting for itself."""
    from production_stack_tpu_torch.engine.config import EngineConfig

    fields = {**({"speculative_model": model} if fields else {}), **fields}
    return EngineConfig(**{
        "model": model, "dtype": "bfloat16", "device": device,
        "max_model_len": 2048, "block_size": 16,
        "num_kv_blocks": SPEC_DP_BLOCKS, "max_num_seqs": 4,
        "max_prefill_seqs": 4, "num_decode_steps": 32, "seed": seed,
        "max_num_batched_tokens": WARM_PREFILL_BUDGET, **fields, **over})


def spec_dp_serve(torch, pa, engine, prompts, prefix_prompt):
    """One engine's rounds in one start: the 4 streams (``SPEC_SAMPLINGS``)
    x ``SPEC_DP_TOKENS``, held until all 4 wait (one prefill batch), then
    a greedy stream over ``prefix_prompt`` (its head cached by the first
    round: its draft ring catches up). Counter growth per round; on a mesh
    every rank's report (counts reset before the 4 streams; pool and ring
    digests after each round), else the kernel's own counts."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    r = engine.runner
    gate = gate_schedule(engine)
    mesh = engine.mesh is not None
    res = {}

    def counters():
        return {k: getattr(r, k) for k in SPEC_DP_COUNTERS}

    def grown(c0):
        return {k: v - c0[k] for k, v in counters().items()}

    async def one(prompt, sampling, n):
        last = None
        async for o in engine.generate(prompt=prompt, sampling=SamplingParams(
                max_tokens=n, ignore_eos=True, **sampling)):
            last = o
        return last.token_ids

    async def run():
        await engine.start()
        try:
            if mesh:
                res["before"] = await engine.rank_reports(reset=True)
            else:
                pa.reset_launch_counts()
            c0, steps0 = counters(), r.decode_steps_total
            dev0 = r.decode_device_seconds_total
            gate["want"] = 4
            t0 = time.monotonic()
            with SmMhz() as clock:
                res["tokens"] = await asyncio.gather(*[
                    one(prompts[i], SPEC_SAMPLINGS[i], SPEC_DP_TOKENS)
                    for i in range(4)])
            res["wall"] = time.monotonic() - t0
            res["clock"] = clock.summary()
            res["device_s"] = r.decode_device_seconds_total - dev0
            res["counters"] = grown(c0)
            res["steps"] = r.decode_steps_total - steps0
            res["launches"] = None if mesh else pa.launch_counts()
            if mesh:
                res["after"] = await engine.rank_reports(pool_digest=True)
            hits0 = engine.stats()["prefix_cache_hits"]
            c0 = counters()
            res["prefix_tokens"] = await one(prefix_prompt, {"temperature": 0.0},
                                             SPEC_DP_TOKENS)
            res["prefix_counters"] = grown(c0)
            res["prefix_hits"] = engine.stats()["prefix_cache_hits"] - hits0
            if mesh:
                res["after_prefix"] = await engine.rank_reports(pool_digest=True)
            res["stats"] = engine.stats()
        finally:
            await engine.stop()

    asyncio.run(run())
    return res


def spec_dp_phase(torch, pa, device, seed, card, cut_dirs):
    """Speculative decoding at data_parallel_size 2: llama-3b drafting for
    itself (N = ``SPEC_N``), both replicas on this card (gloo), against a
    dp = 1 engine on the same weights (``cut_model``'s directory: full
    width, ``CUT_LAYERS`` layers, random bf16 from ``seed``): linear, tree
    (W = 3), adaptive and a spec-off control. Per mode each engine serves the 4 streams x
    ``SPEC_DP_TOKENS`` (2 greedy, 2 seeded) and a stream whose prompt head
    the first round cached (``SPEC_INGEST`` reaches the worker). Bars: the
    tokens and the counters (``SPEC_DP_COUNTERS``) equal dp = 1's in every
    round (the replicas run the same kernels at the same shapes); both
    replicas' pool and draft-ring digests, catch-up counts and token
    digests are equal; the prefix round hit the cache and caught up on
    both replicas; the control's paged kernel launched layers x decode
    steps on each replica and at dp = 1. Returns (the control's launches on
    the replicas, the summary)."""
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.models.config import resolve_model_config

    prompts = spec_prompts(seed)
    prefix_prompt = prompts[0] + " and then the stream goes on past its prefix"
    cut = cut_model(torch, device, seed, SPEC_DP_MODEL, cut_dirs)
    layers = resolve_model_config(cut).num_layers
    out = {"card": card, "n": SPEC_N, "tokens": SPEC_DP_TOKENS,
           "layers": layers, "modes": {}}
    launches, tokens = 0, {}
    for mode, fields in SPEC_DP_MODES:
        what = f"spec-dp {mode}"
        runs = {}
        for dp in (1, 2):
            over = ({"data_parallel_size": dp, "tp_timeout_s": TP_TIMEOUT_S}
                    if dp > 1 else {})
            t0 = time.monotonic()
            engine = ServingEngine(spec_dp_config(cut, fields, seed,
                                                  device.type, **over))
            up = time.monotonic() - t0
            try:
                runs[dp] = spec_dp_serve(torch, pa, engine, prompts,
                                         prefix_prompt)
                runs[dp]["reports"] = engine.tp_reports
            finally:
                engine.shutdown()
            runs[dp]["up_s"] = up
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        one, two = runs[1], runs[2]
        for key in ("tokens", "prefix_tokens"):
            if two[key] != one[key]:
                bad = [i for i, (a, b) in enumerate(zip(two[key], one[key]))
                       if a != b] if key == "tokens" else [0]
                fail(f"{what}: {key} at dp = 2 differ from dp = 1's on streams "
                     f"{bad}: {two[key]} / {one[key]}")
        for key in ("counters", "prefix_counters"):
            if two[key] != one[key]:
                fail(f"{what}: {key} at dp = 2 {two[key]} differ from dp = 1's "
                     f"{one[key]}")
        for key in ("after", "after_prefix"):
            reps = two[key]
            if [tuple(x["coords"]) for x in reps] != [(0, 0, 0), (1, 0, 0)]:
                fail(f"{what}: reports of {[x['coords'] for x in reps]}")
            for field in ("pool_digest", "spec_digest", "spec_ingests",
                          "token_digest", "dispatches"):
                if len({x[field] for x in reps}) != 1:
                    fail(f"{what}: the replicas' {field} differ after "
                         f"{key}: {[x[field] for x in reps]}")
        if two["prefix_hits"] <= 0 or one["prefix_hits"] <= 0:
            fail(f"{what}: the prefix round hit no cached block")
        spec = bool(fields)
        if spec:
            if two["after_prefix"][1]["spec_ingests"] <= \
                    two["after"][1]["spec_ingests"]:
                fail(f"{what}: the prefix round ran no catch-up on the worker")
            if two["counters"]["spec_draft_tokens_total"] <= 0 and \
                    mode != "adaptive":
                fail(f"{what}: no draft proposals counted")
        if not spec:
            # The control: the paged kernel at dp = 1 over the 4 streams,
            # and on each replica over both rounds (reset before the first,
            # read at stop), layers x decode steps.
            n1, steps1 = one["launches"][pa.BF16], one["steps"]
            if n1 != layers * steps1 or not steps1:
                fail(f"{what}: dp = 1 counted {n1} launches over {steps1} "
                     f"decode steps of {layers} layers")
            for b_rep, a_rep in zip(two["before"], two["reports"]):
                n = a_rep["launch_counts"][pa.BF16]
                rs = a_rep["decode_steps_total"] - b_rep["decode_steps_total"]
                if n != layers * rs or not rs:
                    fail(f"{what}: rank {a_rep['rank']} counted {n} launches "
                         f"over {rs} decode steps of {layers} layers")
                launches += n
        n_tok = sum(len(t) for t in two["tokens"])
        row = {
            "engine_up_s": {"dp1": one["up_s"], "dp2": two["up_s"]},
            "ms_per_token_wall": {"dp1": 1e3 * one["wall"] / n_tok,
                                  "dp2": 1e3 * two["wall"] / n_tok},
            "ms_per_token_events": {"dp1": 1e3 * one["device_s"] / n_tok,
                                    "dp2": 1e3 * two["device_s"] / n_tok},
            "counters": two["counters"], "prefix_counters": two["prefix_counters"],
            "decode_steps": {"dp1": one["steps"], "dp2": two["steps"]},
            "spec_ingests_per_replica": [x["spec_ingests"] for x in two["after_prefix"]],
            "tokens_equal_dp1": True,
            "sm_clock_mhz": {dp: r["clock"]["mean"] if isinstance(r["clock"], dict)
                             else None for dp, r in runs.items()},
        }
        if not spec:
            row["launches_per_replica"] = [x["launch_counts"][pa.BF16]
                                           for x in two["reports"]]
            row["launches_dp1"] = one["launches"][pa.BF16]
        out["modes"][mode] = row
        tokens[mode] = two["tokens"]
        log(f"{what} result {json.dumps(row)}")
    # Spec-on against the control (the window path against the paged
    # kernel: reported, not a bar).
    for mode, toks in tokens.items():
        if mode != "off":
            out["modes"][mode]["streams_equal_spec_off"] = [
                a == b for a, b in zip(toks, tokens["off"])]
    return launches, out


# ---------------------------------------------------------------- phase 11
CKPT_TOKENS = 64            # tokens per request
CKPT_SAMPLINGS = ({"temperature": 0.0}, {"temperature": 0.0},
                  {"temperature": 0.8, "seed": 1234},
                  {"temperature": 0.7, "seed": 7})
# The float32 merged-weight check: logits of the engine's adapter row
# against a model whose weights carry the adapter (W + A.B.alpha/r), both
# in f32 with TF32 off; they differ by summation order only (measured
# ~1e-5 on the CPU at tiny width). The adapter itself must move the
# logits by far more than the bound.
CKPT_F32_LAYERS = 2
CKPT_F32_BOUND = 2e-3


def hf_config_json(mc) -> dict:
    """config.json of a llama-family ModelConfig, in HF's field names."""
    return {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": mc.vocab_size, "hidden_size": mc.hidden_size,
        "intermediate_size": mc.intermediate_size,
        "num_hidden_layers": mc.num_layers,
        "num_attention_heads": mc.num_heads,
        "num_key_value_heads": mc.num_kv_heads,
        **({"head_dim": mc.head_dim} if mc.head_dim else {}),
        "max_position_embeddings": mc.max_position_embeddings,
        "rope_theta": mc.rope_theta, "rms_norm_eps": mc.rms_norm_eps,
        "tie_word_embeddings": mc.tie_word_embeddings,
        "attention_bias": mc.attention_bias, "torch_dtype": "bfloat16",
    }


def write_hf_checkpoint(torch, params, mc, path, num_shards=1):
    """Write the port's llama param dict as an HF checkpoint directory:
    HF tensor names, ``[out, in]`` projections, ``num_shards`` safetensors
    files (with ``model.safetensors.index.json`` when more than one) by the
    port's writer, and config.json from ``mc``. Tensors may live on the
    card: each is copied to the host as it is written. Returns the files,
    bytes and seconds."""
    from production_stack_tpu_torch.models import safetensors_io
    from production_stack_tpu_torch.models.weights import _LLAMA_MAP, _LLAMA_TOP

    t0 = time.monotonic()
    os.makedirs(path, exist_ok=True)
    layer_names = {ours: (suffix, tr) for suffix, (ours, tr) in _LLAMA_MAP.items()}
    top_names = {ours: (name, tr) for name, (ours, tr) in _LLAMA_TOP.items()}
    tensors = {}
    for ours, t in params.items():
        if ours != "layers":
            name, tr = top_names[ours]
            tensors[name] = t.t() if tr else t
    for i in range(mc.num_layers):
        for ours, stack in params["layers"].items():
            suffix, tr = layer_names[ours]
            tensors[f"model.layers.{i}.{suffix}"] = stack[i].t() if tr else stack[i]
    if num_shards > 1:
        files = safetensors_io.save_sharded(tensors, path, num_shards)
    else:
        files = ["model.safetensors"]
        safetensors_io.save_file(tensors, os.path.join(path, files[0]),
                                 {"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_json(mc), f, indent=2)
    nbytes = sum(os.path.getsize(os.path.join(path, n)) for n in files)
    return {"files": files, "bytes": nbytes, "seconds": time.monotonic() - t0}


def cut_model(torch, device, seed, model, dirs):
    """``model`` at full width cut to ``CUT_LAYERS`` layers, as an HF
    checkpoint directory of random bf16
    weights from ``seed`` (the port's writer), written at the first call
    and kept in ``dirs`` (model name -> directory) for the later ones; every
    process of a phase loads the same weights from it."""
    from dataclasses import replace

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import resolve_model_config

    if model not in dirs:
        mc = replace(resolve_model_config(model), num_layers=CUT_LAYERS)
        path = os.path.join(os.path.dirname(DETAIL_LOG), f"cut-{model}-{CUT_LAYERS}l")
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = llama.init_params(mc, gen, torch.bfloat16, device)
        info = write_hf_checkpoint(torch, params, mc, path)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"cut model: {model} at {CUT_LAYERS} layers written to {path} "
            f"({info['bytes']} bytes in {info['seconds']:.1f} s)")
        dirs[model] = path
    return dirs[model]


def params_equal(torch, got, want):
    """Names of the leaves of two param dicts that differ in name, dtype,
    shape or any bit ([] when every leaf is equal)."""
    def leaves(p):
        out = {k: v for k, v in p.items() if k != "layers"}
        out.update({f"layers.{k}": v for k, v in p["layers"].items()})
        return out

    g, w = leaves(got), leaves(want)
    return sorted(k for k in g.keys() | w.keys()
                  if k not in g or k not in w or g[k].dtype != w[k].dtype
                  or g[k].shape != w[k].shape or not torch.equal(g[k], w[k]))


def write_peft_adapter(torch, path, mc, rank, targets, alpha, generator,
                       scale=1.0):
    """A PEFT adapter directory (bf16 ``adapter_model.safetensors`` and
    ``adapter_config.json``): per layer and target lora_A [r, in] and
    lora_B [out, r], random and nonzero (``models/lora.py``'s draw, from
    ``generator``)."""
    from production_stack_tpu_torch.models import lora, safetensors_io

    ad = lora.init_random_adapter("w", mc, generator, rank=rank,
                                  targets=targets, scale=scale)
    tensors = {}
    for target in targets:
        a, b = ad.layers[target]
        grp = "mlp" if target.startswith("w_") else "self_attn"
        for i in range(mc.num_layers):
            pre = (f"base_model.model.model.layers.{i}.{grp}."
                   f"{lora.TARGET_TO_PEFT[target]}")
            tensors[f"{pre}.lora_A.weight"] = a[i].t()
            tensors[f"{pre}.lora_B.weight"] = b[i].t()
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha, "peft_type": "LORA",
                   "target_modules": [lora.TARGET_TO_PEFT[t] for t in targets]}, f)
    return path


def ckpt_server_config(model, served, seed, device, *extra):
    """The engine config the port's server builds from its flags for the
    ckpt phase: ``--model`` (a named config or a directory) served as
    ``served``, bf16 KV, block 16, 1024 blocks, 4 rows, graphs captured at
    warm-up (the server's default)."""
    from production_stack_tpu_torch.server.api_server import (
        config_from_args,
        parse_args,
    )

    return config_from_args(parse_args([
        "--model", model, "--served-model-name", served,
        "--device", device.type, "--max-model-len", "2048", "--num-kv-blocks", "1024",
        "--max-num-seqs", "4", "--num-decode-steps", "32", "--attn-impl", "paged",
        "--max-num-batched-tokens", str(WARM_PREFILL_BUDGET),
        "--seed", str(seed), *extra]))


class RssPeak:
    """This process's resident set, sampled every 10 ms while a block runs:
    ``base`` and ``peak`` of VmRSS, and the peaks of its anonymous and
    file-backed parts (RssAnon, RssFile), in bytes."""

    KEYS = ("VmRSS", "RssAnon", "RssFile")

    def __enter__(self):
        self.base = self.read()
        self.peaks = dict(self.base)
        self._stop = threading.Event()

        def run():
            while not self._stop.wait(0.01):
                self._sample()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        for k, v in self.read().items():
            self.peaks[k] = max(self.peaks.get(k, 0), v)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(5)
        self._sample()
        return False

    def summary(self):
        """GiB: VmRSS at the start and its peak, and the peak over the
        start of each part the kernel reports ("not read" when it does
        not)."""
        gib = 2**30
        out = {"rss_base_gib": self.base.get("VmRSS", "not read"),
               "rss_peak_gib": self.peaks.get("VmRSS", "not read")}
        for key, name in (("VmRSS", "rss"), ("RssAnon", "rss_anon"),
                          ("RssFile", "rss_file")):
            out[f"{name}_peak_over_base_gib"] = (
                (self.peaks[key] - self.base[key]) / gib if key in self.base
                else "not read")
        return {k: v / gib if isinstance(v, int) else v for k, v in out.items()}

    @classmethod
    def read(cls):
        out = {}
        with open("/proc/self/status") as f:
            for line in f:
                key = line.split(":")[0]
                if key in cls.KEYS:
                    out[key] = int(line.split()[1]) * 1024
        return out


def plain_read_gbps(files) -> float:
    """GB/s of a plain read of the files into one reused 64 MiB buffer."""
    buf = bytearray(64 << 20)
    t0, n = time.monotonic(), 0
    for path in files:
        with open(path, "rb", buffering=0) as f:
            while True:
                got = f.readinto(buf)
                if not got:
                    break
                n += got
    return n / (time.monotonic() - t0) / 1e9


def ckpt_http_round(torch, pa, engine, gate, prompts, models, what):
    """The 4 streamed completions (``CKPT_SAMPLINGS``, ``models[i]`` each:
    the base model or an adapter) behind the port's server, held until all
    4 wait so they form one prefill batch, the prefix cache emptied first
    (every round starts cold). Checks /v1/models, every stream's length, no
    eager decode dispatch, and the paged kernel's own count: 28 x decode
    steps of the bf16 variant, 0 of int8. Returns (token ids per stream,
    a row of numbers)."""
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    r = engine.runner
    out = {}

    async def run():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        st, body, _, _ = await loop.run_in_executor(
            None, http, "GET", base + "/v1/models")
        out["models"] = [m["id"] for m in body["data"]] if st == 200 else st
        engine.block_manager.reset_prefix_cache()
        for key in ("decode_steps_total", "decode_tokens_total",
                    "decode_seconds_total", "decode_device_seconds_total",
                    "prefill_seconds_total"):
            setattr(r, key, 0)
        engine.decode_dispatches_total = engine.prefill_dispatches_total = 0
        train = r.decode_train
        eager0, graph0 = train.eager_dispatches_total, train.graph_dispatches_total
        if r.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        pa.reset_launch_counts()
        gate["want"] = 4
        t0 = time.monotonic()

        def one(i):
            body = {"model": models[i], "prompt": prompts[i],
                    "max_tokens": CKPT_TOKENS, "stream": True,
                    "ignore_eos": True, **CKPT_SAMPLINGS[i]}
            t = time.monotonic()
            st, evs, t_first, _ = http("POST", base + "/v1/completions", body,
                                       True, headers={"x-pstpu-resume": "1"})
            if st != 200 or evs[-1] != "[DONE]":
                fail(f"ckpt {what}: request {i}: HTTP {st}")
            toks = [t for e in evs[:-1] for t in e.get("pstpu", {}).get("toks", [])]
            return toks, t_first - t

        with SmMhz() as clock:
            res = await asyncio.gather(*[loop.run_in_executor(None, one, i)
                                         for i in range(4)])
        out.update(res=res, wall=time.monotonic() - t0, clock=clock.summary(),
                   launches=pa.launch_counts(), stats=engine.stats(),
                   eager=train.eager_dispatches_total - eager0,
                   graph=train.graph_dispatches_total - graph0,
                   peak=(torch.cuda.max_memory_allocated() / 2**30
                         if r.device.type == "cuda" else None))
        await server.stop()

    asyncio.run(run())
    toks = [t for t, _ in out["res"]]
    if any(len(t) != CKPT_TOKENS for t in toks):
        fail(f"ckpt {what}: stream lengths {[len(t) for t in toks]}")
    st = out["stats"]
    steps = st["decode_steps_total"]
    nl = engine.model_config.num_layers
    if r.device.type != "cuda":
        log(f"ckpt {what}: off the card: the graph and launch checks skipped")
    elif out["eager"] or not out["graph"]:
        fail(f"ckpt {what}: {out['eager']} eager decode dispatches after "
             f"warm-up ({out['graph']} replayed)")
    elif out["launches"] != {**dict.fromkeys(pa.VARIANTS, 0), pa.BF16: nl * steps}:
        fail(f"ckpt {what}: kernel launches {out['launches']} for {steps} "
             f"decode steps of {nl} layers")
    dev_s = st["decode_device_seconds_total"]
    row = {
        "models_listed": out["models"], "wall_s": out["wall"],
        "aggregate_tok_s": 4 * CKPT_TOKENS / out["wall"],
        "ttft_s": [f for _, f in out["res"]], "decode_steps": steps,
        "decode_dispatches": st["decode_dispatches_total"],
        "decode_ms_per_step_events": 1e3 * dev_s / steps if steps else None,
        "launches": out["launches"][pa.BF16],
        "graph_pool_bytes": st["graph_pool_bytes"],
        "graph_families": st["graph_families"],
        "peak_mem_gib": out["peak"], "sm_clock_mhz": out["clock"],
    }
    log(f"ckpt {what}: {json.dumps(row)}")
    return toks, row


def ckpt_api_round(engine, gate, prompts, models, eager=False):
    """The 4 requests on the engine API, cold (the prefix cache emptied)
    and held by ``gate`` until all wait; ``eager`` sets the captured graphs
    aside and runs the strict loop (the strict eager train on the same
    batches). Returns (each stream's tokens, the round's eager and
    replayed decode dispatches)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    r, cfg = engine.runner, engine.config
    train = r.decode_train
    saved = (train.graphs, cfg.async_pipeline, cfg.overlap_dispatch,
             r.prefill_train.graphs)
    e0, g0 = train.eager_dispatches_total, train.graph_dispatches_total

    async def run():
        await engine.start()
        engine.block_manager.reset_prefix_cache()
        if eager:
            train.graphs = r.prefill_train.graphs = {}
            cfg.async_pipeline = cfg.overlap_dispatch = False
        gate["want"] = len(prompts)

        async def one(i):
            last = None
            ad = None if models[i] == engine.config.model_name else models[i]
            async for o in engine.generate(
                    prompt=prompts[i], lora_adapter=ad,
                    sampling=SamplingParams(max_tokens=CKPT_TOKENS,
                                            ignore_eos=True, **CKPT_SAMPLINGS[i])):
                last = o
            return last.token_ids

        try:
            return await asyncio.gather(*[one(i) for i in range(len(prompts))])
        finally:
            await engine.stop()

    try:
        toks = asyncio.run(run())
    finally:
        (train.graphs, cfg.async_pipeline, cfg.overlap_dispatch,
         r.prefill_train.graphs) = saved
    return toks, (train.eager_dispatches_total - e0,
                  train.graph_dispatches_total - g0)


def ckpt_prefix_isolation(engine, prompt):
    """The same prompt under adapter a, then the base model, then a again:
    the base request hits no block a computed (the hit counter stands
    still), a's second request hits them. Returns the counts."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    bm = engine.block_manager
    counts = {}

    async def run():
        await engine.start()
        bm.reset_prefix_cache()
        try:
            for tag, ad in (("a", "a"), ("base", None), ("a again", "a")):
                h0 = bm.prefix_hits_total
                async for _ in engine.generate(
                        prompt=prompt, lora_adapter=ad, sampling=SamplingParams(
                            max_tokens=4, temperature=0.0, ignore_eos=True)):
                    pass
                counts[tag] = bm.prefix_hits_total - h0
        finally:
            await engine.stop()

    asyncio.run(run())
    if counts["base"] != 0 or counts["a again"] <= 0:
        fail(f"ckpt: prefix blocks shared across adapters: hits {counts}")
    return counts


def ckpt_merged_check(torch, pa, device, seed, root, model="llama-3b"):
    """The adapter arithmetic at llama-3b width, depth cut to
    ``CKPT_F32_LAYERS``, in float32: an engine on the checkpoint (bf16
    file, loaded as f32) with adapter m (rank 16 on all seven targets)
    serves one greedy row under m; its logits at every generated position
    (the prefill's and each decode step's) against a plain forward of the
    same tokens through a model whose weights are merged, W + A.B.alpha/r.
    Fails past ``CKPT_F32_BOUND``, or when the adapter moves the logits by
    less than 10x the bound (an adapter that was not applied). Its decode
    runs the paged kernels' generic float32 variant: the count must be
    layers x decode steps."""
    from dataclasses import replace

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.models import llama, lora
    from production_stack_tpu_torch.models.config import resolve_model_config

    mc = replace(resolve_model_config(model), num_layers=CKPT_F32_LAYERS)
    gen = torch.Generator(device).manual_seed(seed + 1)
    p16 = llama.init_params(mc, gen, torch.bfloat16, device)
    d = os.path.join(root, "f32")
    write_hf_checkpoint(torch, p16, mc, d)
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    dm = write_peft_adapter(torch, os.path.join(root, "m"), mc, 16, targets,
                            32, torch.Generator(device).manual_seed(seed + 2))
    eng = ServingEngine(EngineConfig(
        model=d, dtype="float32", device=device.type, max_model_len=512,
        num_kv_blocks=64, max_num_seqs=1, num_decode_steps=8,
        decode_loop="while", lora_modules={"m": dm}))
    prompt = list(range(100, 140))
    n_gen = 9
    sink = []

    counted = {}

    async def run():
        await eng.start()
        eng.runner.logits_sink = sink
        pa.reset_launch_counts()
        steps0 = eng.runner.decode_steps_total
        try:
            last = None
            async for o in eng.generate(prompt_token_ids=prompt, lora_adapter="m",
                                        sampling=SamplingParams(
                                            max_tokens=n_gen, temperature=0.0,
                                            ignore_eos=True)):
                last = o
            counted.update(launches=pa.launch_counts(),
                           steps=eng.runner.decode_steps_total - steps0)
            return last.token_ids
        finally:
            eng.runner.logits_sink = None
            await eng.stop()

    toks = asyncio.run(run())
    variant = engine_variant(pa, eng)
    want = {**dict.fromkeys(pa.VARIANTS, 0), variant: mc.num_layers * counted["steps"]}
    if device.type == "cuda" and (eng.runner.attn_impl != "paged"
                                  or counted["launches"] != want):
        fail(f"ckpt merged-weight check: attn {eng.runner.attn_impl}, kernel "
             f"counts {counted['launches']}, want {want}")
    got = torch.stack([sink[j][0] for j in range(n_gen)])      # [n_gen, V]
    eng.shutdown()
    ad = lora.load_peft_adapter("m", dm, mc, dtype=torch.float32)
    base = {k: (v.float() if k != "layers" else {n: t.float() for n, t in v.items()})
            for k, v in p16.items()}
    merged = {**base, "layers": dict(base["layers"])}
    for t, (a, b) in ad.layers.items():
        merged["layers"][t] = base["layers"][t] + torch.bmm(a.to(device), b.to(device))
    seq = prompt + toks[:-1]
    n = len(seq)

    def logits_of(params):
        ids = torch.tensor([seq], dtype=torch.int32, device=device)
        pos = torch.arange(n, dtype=torch.int32, device=device)[None]
        hid, _, _ = llama.forward(params, mc, ids, pos,
                                  torch.tensor([n], dtype=torch.int32, device=device))
        return llama.compute_logits(params, mc, hid[0, len(prompt) - 1:])

    with torch.no_grad():
        want = logits_of(merged)
        plain = logits_of(base)
    err = float((got - want).abs().max())
    moved = float((plain - want).abs().max())
    argmax_equal = bool((want.argmax(-1) == torch.tensor(toks, device=device)).all())
    row = {"layers": CKPT_F32_LAYERS, "tokens": n_gen, "variant": variant,
           "launches": counted["launches"][variant], "max_abs_logit_diff": err,
           "bound": CKPT_F32_BOUND, "adapter_moves_logits_by": moved,
           "argmax_equal": argmax_equal}
    log(f"ckpt merged-weight check: {json.dumps(row)}")
    if not err <= CKPT_F32_BOUND or moved < 10 * CKPT_F32_BOUND:
        fail(f"ckpt merged-weight check: {row}")
    del p16, base, merged
    return row


def ckpt_phase(torch, pa, device, seed, card, model="llama-3b",
               served="llama-3b"):
    """The ``ckpt`` phase (see the module docstring): ``model`` (a named
    config, or ``cut_model``'s directory of one) written as an HF checkpoint
    directory, loaded and served behind the port's server as ``served``,
    then with two PEFT adapters. The tokens to match come from ``model``'s
    random weights drawn from ``seed`` (for a directory, its config with
    ``load_format="dummy"``: the draw ``cut_model`` wrote). Returns (the
    bf16 kernel's launches over the served rounds, the summary)."""
    import shutil
    from dataclasses import replace

    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.models import llama, lora
    from production_stack_tpu_torch.models.config import resolve_model_config

    mc = resolve_model_config(model)
    prompts = spec_prompts(seed + 1)
    out = {"card": card}
    launches = 0
    # Up to 6.4 GB of checkpoint (llama-3b at full depth): under the
    # gitignored output directory, and removed whatever happens.
    os.makedirs(os.path.dirname(DETAIL_LOG), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt-", dir=os.path.dirname(DETAIL_LOG))
    try:
        # 1. write: the named config's draw from --seed, as an HF directory
        gen = torch.Generator(device).manual_seed(seed)
        params = llama.init_params(mc, gen, torch.bfloat16, device)
        ckdir = os.path.join(root, "model")
        info = write_hf_checkpoint(torch, params, mc, ckdir, num_shards=2)
        out["write"] = {"bytes": info["bytes"], "files": len(info["files"]),
                        "seconds": info["seconds"],
                        "gbps": info["bytes"] / info["seconds"] / 1e9}
        log(f"ckpt write: {json.dumps(info)}")

        # 2. the named-config engine from the same seed: the tokens to match
        named = ServingEngine(replace(ckpt_server_config(model, served, seed,
                                                         device),
                                      load_format="dummy"))
        want, row = ckpt_http_round(torch, pa, named, gate_schedule(named),
                                    prompts, [served] * 4, "named config")
        launches += row["launches"]
        out["named"] = row
        named.shutdown()
        del named
        gc.collect()
        torch.cuda.empty_cache()

        # 3. load: the server's --model <dir> (the weights filled on the
        # loader thread, joined here; this first start of the directory's
        # config writes its manifest)
        with RssPeak() as rss:
            eng = ServingEngine(ckpt_server_config(
                ckdir, served, seed, device, "--compilation-cache-dir",
                ELASTIC_CACHE))
            eng.runner.wait_for_weights()
        r = eng.runner
        files = [os.path.join(ckdir, n) for n in info["files"]]
        load_s = r.startup_weight_load_seconds
        out["load"] = {
            "seconds": load_s, "gbps": info["bytes"] / load_s / 1e9,
            "plain_read_gbps": plain_read_gbps(files), **rss.summary(),
            "tokenizer": type(eng.tokenizer).__name__,
        }
        if out["load"]["tokenizer"] != "ByteTokenizer":
            fail(f"ckpt: tokenizer {out['load']['tokenizer']} (no tokenizer "
                 "file was written)")
        fields = [f for f in mc.__dataclass_fields__ if f != "name"]
        diff = [f for f in fields if getattr(eng.model_config, f) != getattr(mc, f)]
        if diff:
            fail(f"ckpt: the directory's config differs from {model}'s in {diff}")
        bad = params_equal(torch, r.params, params)
        if bad:
            fail(f"ckpt: loaded leaves differ from the written params: {bad}")
        out["load"]["leaves_equal"] = len(params["layers"]) + len(params) - 1
        del params
        gc.collect()
        torch.cuda.empty_cache()
        gate = gate_schedule(eng)
        got, row = ckpt_http_round(torch, pa, eng, gate, prompts,
                                   [served] * 4, "checkpoint")
        launches += row["launches"]
        out["checkpoint"] = row
        if got != want:
            fail("ckpt: tokens served from the checkpoint differ from the named "
                 f"config's on streams {[i for i in range(4) if got[i] != want[i]]}")
        # the elastic phase's overlap against serial, on the directory
        out["overlap"] = ckpt_overlap(torch, pa, device, seed, ckdir, served,
                                      prompts)

        # 4. LoRA: two PEFT adapters beside the checkpoint
        dgen = torch.Generator(device).manual_seed(seed + 100)
        da = write_peft_adapter(torch, os.path.join(root, "a"), mc, 8,
                                ("wq", "wv"), 16, dgen)
        db = write_peft_adapter(torch, os.path.join(root, "b"), mc, 16,
                                ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                 "w_down"), 32, dgen)
        # The adapters reach the engine through the LoraAdapter controller:
        # copied into its shared directory, loaded from the paths it
        # reports on the CRs' status.
        paths, out["lora_controller"] = lora_controller_paths(
            root, {"a": da, "b": db}, os.path.dirname(DETAIL_LOG))
        # The directory's config again (adapters do not key the manifest):
        # the default variants only, as every round here is of them.
        leng = ServingEngine(ckpt_server_config(
            ckdir, served, seed, device, "--lora-modules", f"a={paths['a']}",
            f"b={paths['b']}", "--compilation-cache-dir", ELASTIC_CACHE))
        lgate = gate_schedule(leng)
        models = [served, "a", "b", "a"]
        ltoks, row = ckpt_http_round(torch, pa, leng, lgate, prompts, models,
                                     "lora")
        launches += row["launches"]
        out["lora"] = row
        if row["models_listed"] != [served, "a", "b"]:
            fail(f"ckpt: /v1/models lists {row['models_listed']}")
        if ltoks[0] != got[0]:
            fail("ckpt: the base row beside adapter rows differs from the "
                 "no-adapter engine's in the same batch shape")
        same = [i for i in (1, 2, 3) if ltoks[i] == got[i]]
        if same:
            fail(f"ckpt: adapter rows {same} equal the base model's tokens")
        graph_toks, graph_n = ckpt_api_round(leng, lgate, prompts, models)
        eager_toks, eager_n = ckpt_api_round(leng, lgate, prompts, models,
                                             eager=True)
        out["graph_vs_eager"] = {"graph_run_eager_replayed": graph_n,
                                 "eager_run_eager_replayed": eager_n}
        if not graph_toks == eager_toks == ltoks:
            fail("ckpt: LoRA graph replay, the strict eager train and the "
                 "served round differ")
        if device.type == "cuda" and (graph_n[0] or not graph_n[1]
                                      or not eager_n[0] or eager_n[1]):
            fail(f"ckpt: decode dispatches (eager, replayed): graph run "
                 f"{graph_n}, strict eager run {eager_n}")
        out["prefix_hits"] = ckpt_prefix_isolation(leng, prompts[1])
        out["lora_stack_bytes"] = lora.stack_bytes(leng.runner.lora_stacks)
        out["graph_pool_bytes"] = {"base": eng.stats()["graph_pool_bytes"],
                                   "lora": leng.stats()["graph_pool_bytes"]}
        # Decode ms per step, no adapters against adapters, alternated.
        timing = []
        for what, e, g, ms in (("base", eng, gate, [served] * 4),
                               ("lora", leng, lgate, models),
                               ("lora", leng, lgate, models),
                               ("base", eng, gate, [served] * 4)):
            t, row = ckpt_http_round(torch, pa, e, g, prompts, ms, f"timed {what}")
            launches += row["launches"]
            if t != (ltoks if what == "lora" else got):
                fail(f"ckpt timed {what}: tokens differ from the first round")
            timing.append([what, row["decode_ms_per_step_events"],
                           sum(row["ttft_s"]) / 4, row["aggregate_tok_s"],
                           row["sm_clock_mhz"]["mean"]
                           if isinstance(row["sm_clock_mhz"], dict) else None])
        out["timing_fields"] = ["engine", "ms_per_step_events", "ttft_s_mean",
                                "tok_s", "sm_clock_mhz_mean"]
        out["timing"] = timing
        eng.shutdown()
        leng.shutdown()
        del eng, leng
        gc.collect()
        torch.cuda.empty_cache()

        # 5. the adapter arithmetic in float32 against merged weights
        out["merged_f32"] = ckpt_merged_check(torch, pa, device, seed, root, served)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, out


# ---------------------------------------------------------------- elastic
def elastic_requests(prompts):
    """The elastic phase's rounds: (name, prompts, sampling fields, tokens
    per stream). The serving phase's 4 requests (its prompts and seeds),
    then one logprobs request (b = 1), one with presence and frequency
    penalties (b = 1; a prompt within the 128-token prefill floor, whose
    penalty family warm-up captures on a cold start) and two logprobs
    requests that decode together (b = 2), then one logprobs request whose
    prompt is ~2,000 tokens (the (1, 2048) prefill family's logprob
    variant): on a manifest-verified start each of the last four is a first
    use of deferred variants."""
    long_prompt = (prompts[3] + " " + prompts[0])[:ELASTIC_LONG_PROMPT]
    return [
        ("streams", list(prompts),
         [dict(temperature=0.0), dict(temperature=0.8, top_p=0.9, seed=1234),
          dict(temperature=0.0), dict(temperature=0.7, top_k=50, seed=7)],
         ELASTIC_TOKENS),
        ("logprobs b=1", [prompts[0]], [dict(temperature=0.0, logprobs=5)],
         ELASTIC_FIRST_USE_TOKENS),
        ("penalties b=1", [prompts[1][:100]],
         [dict(temperature=0.8, seed=3, presence_penalty=0.5,
               frequency_penalty=0.3)], ELASTIC_FIRST_USE_TOKENS),
        ("logprobs b=2", [prompts[2][:100], prompts[3][:100]],
         [dict(temperature=0.0, logprobs=5),
          dict(temperature=0.7, top_k=50, seed=7, logprobs=5)],
         ELASTIC_FIRST_USE_TOKENS),
        ("logprobs long b=1", [long_prompt], [dict(temperature=0.0, logprobs=5)],
         ELASTIC_FIRST_USE_TOKENS),
    ]


def deferred_by_rule(runner):
    """The variants a manifest-verified start defers, by the reference's
    rule (its ``warmup``: len(variants) - 1 per family): decode families
    warm (logprobs) and, at b = 1, (penalties); single-row prefill families
    warm (logprobs) and, at (1, t_floor, no window), (penalties)."""
    from production_stack_tpu_torch.utils import prefill_t_floor

    t_floor = prefill_t_floor(runner.config.max_num_batched_tokens)
    dec = sum(2 if b == 1 else 1 for b, _, _ in runner.reachable_decode_families())
    pre = sum(2 if t == t_floor and not hw else 1
              for b, t, _, hw in runner.reachable_prefill_families() if b == 1)
    return dec + pre


def start_row(engine, up_s):
    """One engine's start: seconds by phase, variants warmed and deferred,
    the graph pool and its prefill share, the KV blocks."""
    st = engine.stats()
    r = engine.runner
    return {
        "up_s": up_s, "total_s": st["startup_total_seconds"],
        "warmup_s": st["startup_warmup_seconds"],
        "weight_load_s": st["startup_weight_load_seconds"],
        "overlapped_s": st["startup_compile_seconds"],
        "phases": st["startup_phase_seconds"],
        "variants_warmed": st["startup_cache_miss_families"],
        "deferred": st["startup_deferred_families"],
        "decode_graph_families": st["graph_families"],
        "prefill_graph_families": st["prefill_graph_families"],
        "graph_pool_bytes": st["graph_pool_bytes"],
        "graph_pool_bytes_prefill": st["graph_pool_bytes_prefill"],
        "graph_pool_bytes_logprobs": st["graph_pool_bytes_logprobs"],
        "kv_num_blocks": r.num_kv_blocks,
        "weights_ready": st["weights_ready"],
    }


def elastic_rounds(torch, pa, engine, prompts, what, t_built=None):
    """Start ``engine`` (its warm-up when it is fresh, built at ``t_built``),
    serve the elastic
    rounds (``elastic_requests``) on the engine API, each with the prefix
    cache emptied and held until its requests wait so they form one
    prefill batch, and stop it. Checks every round's stream lengths, no
    eager decode dispatch and the kernel's own count: layers x (decode
    steps + the one dummy step of each decode variant captured at its
    first use) of the bf16 variant, none of int8. Returns (the start row,
    one row per round)."""
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    r = engine.runner
    nl = engine.model_config.num_layers
    gate = gate_schedule(engine)
    rows = []
    out = {}

    async def run():
        await engine.start()
        # Construction to serving for a fresh engine; the serving phase's
        # engine was started there (its start: startup_total_seconds).
        out["start"] = start_row(engine, None if t_built is None
                                 else time.monotonic() - t_built)
        for name, ps, sps, n in elastic_requests(prompts):
            engine.block_manager.reset_prefix_cache()
            c0 = (r.decode_train.eager_dispatches_total,
                  r.prefill_train.eager_dispatches_total,
                  r.deferred_captures_total, r.deferred_capture_seconds_total,
                  r.decode_steps_total, len(r.decode_train.deferred))
            pa.reset_launch_counts()
            gate["want"] = len(ps)
            t = time.monotonic()

            async def one(p, sp):
                first = last = None
                async for o in engine.generate(prompt=p, sampling=SamplingParams(
                        max_tokens=n, ignore_eos=True, **sp)):
                    if first is None:
                        first = time.monotonic() - t
                    last = o
                return list(last.token_ids), last.logprobs, first

            with SmMhz() as clock:
                res = await asyncio.gather(*[one(p, sp) for p, sp in zip(ps, sps)])
            wall = time.monotonic() - t
            counts = pa.launch_counts()
            steps = r.decode_steps_total - c0[4]
            # A decode variant captured at its first use runs one dummy step
            # (every layer's kernel once) on the capture stream first.
            first_decode = c0[5] - len(r.decode_train.deferred)
            row = {"round": name, "wall_s": wall, "ttft_s": [x[2] for x in res],
                   "tokens": [x[0] for x in res], "logprobs": [x[1] for x in res],
                   "decode_eager": r.decode_train.eager_dispatches_total - c0[0],
                   "prefill_eager": r.prefill_train.eager_dispatches_total - c0[1],
                   "first_use_captures": r.deferred_captures_total - c0[2],
                   "first_use_hold_s": r.deferred_capture_seconds_total - c0[3],
                   "first_use_decode_captures": first_decode,
                   "decode_steps": steps, "launches": counts[pa.BF16],
                   "sm_clock_mhz": clock.summary()}
            if any(len(tk) != n for tk in row["tokens"]):
                fail(f"elastic {what} {name}: stream lengths "
                     f"{[len(tk) for tk in row['tokens']]}, want {n}")
            if r.device.type != "cuda":
                log(f"elastic {what} {name}: off the card: the graph and launch "
                    "checks skipped")
            elif row["decode_eager"]:
                fail(f"elastic {what} {name}: {row['decode_eager']} eager decode "
                     "dispatches")
            elif counts != {**dict.fromkeys(pa.VARIANTS, 0),
                            pa.BF16: nl * (steps + first_decode)} \
                    or not steps:
                fail(f"elastic {what} {name}: kernel launches {counts} for "
                     f"{steps} decode steps of {nl} layers and {first_decode} "
                     "decode variants captured at first use")
            log(f"elastic {what} {name}: " + json.dumps(
                {k: v for k, v in row.items() if k not in ("tokens", "logprobs")}))
            rows.append(row)
        await engine.stop()

    asyncio.run(run())
    return out["start"], rows


def elastic_phase(torch, pa, device, seed, card, prompts, cold=None,
                  model="llama-3b"):
    """Fast start at the serving phase's config (``model``: llama-3b at
    full width, cut to ``CUT_LAYERS`` in ``main``; bf16 KV): ``cold`` is (the start row, the round rows) of the
    cold, overlapped start (a) (the serving phase's engine, which wrote
    the manifest), or None to boot (a) here. Boots an identical engine (b),
    which finds the manifest and holds a ballast of the memory (a)'s block
    cap left spare (``boot``): its warm-up captures the default variants
    only, defers the reference's count, keeps (a)'s KV blocks; its rounds
    give (a)'s tokens and logprobs bit for bit, and each first-use round
    captures its deferred variants (their seconds: the worker thread's
    hold), never an eager decode dispatch, and the prefill's eager
    dispatches equal (a)'s (the 2-row logprobs prefill is a variant no
    start captures, the reference's rule). Returns (the bf16 kernel's
    launches over both engines' rounds, the summary)."""
    from production_stack_tpu_torch.engine.engine import ServingEngine

    def boot(what, ballast=False):
        """Build an engine of the serving config and serve the rounds on
        it; with ``ballast``, hold the memory the block cap left spare
        (the blocks free memory allowed less those the pool took) from
        right after the pool is sized, so warm-up and the first uses run
        in the room a pool sized from free memory leaves."""
        t0 = time.monotonic()
        engine = ServingEngine(serving_config(seed, "bfloat16", device.type, model))
        held, room = None, {}
        if ballast and device.type == "cuda":
            r = engine.runner
            spare = ((r.kv_blocks_free_memory - r.num_kv_blocks)
                     * (r.kv_pool_bytes // r.num_kv_blocks))
            if spare > 0:
                held = torch.empty((spare,), dtype=torch.uint8, device=device)
            torch.cuda.reset_peak_memory_stats(device)
            room = {"ballast_bytes": max(0, spare),
                    "kv_blocks_free_memory": r.kv_blocks_free_memory,
                    "loader_reserve_bytes": r.loader_reserve_bytes,
                    "prefill_reserve_bytes": r.prefill_reserve_bytes}
        start, rows = elastic_rounds(torch, pa, engine, prompts, what, t0)
        if room:
            room["peak_reserved_bytes"] = torch.cuda.max_memory_reserved(device)
            room["total_bytes"] = torch.cuda.get_device_properties(
                device).total_memory
            room["free_bytes_after_rounds"] = torch.cuda.mem_get_info(device)[0]
            log(f"elastic {what}: memory {json.dumps(room)}")
        del held
        return engine, start, rows, room

    if cold is None:
        engine, *cold, _ = boot("cold")
        engine.shutdown()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    cold_start, cold_rows = cold
    engine, start, rows, room = boot("verified", ballast=True)
    r = engine.runner
    captured_d = set(r.decode_train.graphs)
    captured_p = set(r.prefill_train.graphs)
    want = deferred_by_rule(r)
    defaults_d = {k for k in r.decode_graph_keys() if not (k[3] or k[4])}
    defaults_p = {k for k in r.prefill_graph_keys() if not (k[4] or k[5])}
    pool_after = engine.stats()["graph_pool_bytes"]
    engine.shutdown()
    del engine, r
    gc.collect()
    torch.cuda.empty_cache()
    if start["deferred"] != want or not want:
        fail(f"elastic: the verified start deferred {start['deferred']} variants, "
             f"the reference's rule gives {want}")
    if start["variants_warmed"] != len(defaults_d) + len(defaults_p):
        fail(f"elastic: the verified start warmed {start['variants_warmed']} "
             f"variants, want the {len(defaults_d) + len(defaults_p)} defaults")
    if start["kv_num_blocks"] != cold_start["kv_num_blocks"]:
        fail(f"elastic: {start['kv_num_blocks']} KV blocks on the verified start, "
             f"{cold_start['kv_num_blocks']} on the cold one")
    if device.type == "cuda":
        firsts = captured_d - defaults_d, captured_p - defaults_p
        if not defaults_d <= captured_d or not defaults_p <= captured_p:
            fail("elastic: the verified start did not capture every default "
                 "variant")
        log(f"elastic: after the rounds, {len(firsts[0])} decode and "
            f"{len(firsts[1])} prefill variants were captured at first use")
    launches = 0
    table = []
    for a, b in zip(cold_rows, rows):
        name = a["round"]
        launches += a["launches"] + b["launches"]
        if a["tokens"] != b["tokens"] or a["logprobs"] != b["logprobs"]:
            fail(f"elastic {name}: the verified start's tokens or logprobs differ "
                 f"from the cold start's: tokens equal "
                 f"{[x == y for x, y in zip(a['tokens'], b['tokens'])]}")
        if a["first_use_captures"]:
            fail(f"elastic {name}: the cold start captured "
                 f"{a['first_use_captures']} variants at first use")
        if (b["first_use_captures"] > 0) != (name != "streams"):
            fail(f"elastic {name}: {b['first_use_captures']} first-use captures "
                 "on the verified start")
        if b["prefill_eager"] != a["prefill_eager"]:
            fail(f"elastic {name}: {b['prefill_eager']} eager prefill dispatches "
                 f"on the verified start against {a['prefill_eager']} on the cold")
        table.append([name, a["wall_s"], b["wall_s"], max(a["ttft_s"]),
                      max(b["ttft_s"]), b["first_use_captures"],
                      b["first_use_hold_s"], a["prefill_eager"], b["decode_steps"],
                      b["launches"]])
    out = {"card": card, "cold": cold_start, "verified": start,
           "deferred_by_rule": want,
           "graph_pool_bytes_after_first_uses": pool_after,
           "verified_memory": room,
           "warmup_share": start["warmup_s"] / cold_start["warmup_s"],
           "rounds_fields": ["round", "wall_s_cold", "wall_s_verified",
                             "ttft_s_max_cold", "ttft_s_max_verified",
                             "first_use_captures", "first_use_hold_s",
                             "prefill_eager", "decode_steps", "launches"],
           "rounds": table, "tokens_and_logprobs_equal": True}
    log(f"elastic result {json.dumps(out)}")
    return launches, out


def ckpt_overlap(torch, pa, device, seed, ckdir, served, prompts):
    """Overlap against serial: the checkpoint directory booted from the
    server's flags with ``--no-overlap-weight-load``, without it, and with
    it again (serial boots on both sides of the overlapped one, so the
    order of the boots is not read as the overlap's effect), each finding
    the manifest the ckpt phase's first boot of it wrote and serving the 4
    requests as one batch on the engine API. Load seconds, the warm-up
    seconds beside the load and their share of it, start-to-serving and
    start-to-first-token; tokens equal."""
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams

    rows, toks = {}, {}
    for mode, extra in (("serial", ["--no-overlap-weight-load"]),
                        ("overlapped", []),
                        ("serial again", ["--no-overlap-weight-load"])):
        t0 = time.monotonic()
        eng = ServingEngine(ckpt_server_config(
            ckdir, served, seed, device, "--compilation-cache-dir",
            ELASTIC_CACHE, *extra))
        gate = gate_schedule(eng)
        first = []

        async def run():
            await eng.start()
            t_up = time.monotonic() - t0
            gate["want"] = 4

            async def one(i):
                last = None
                async for o in eng.generate(prompt=prompts[i], sampling=SamplingParams(
                        max_tokens=CKPT_TOKENS, ignore_eos=True, **CKPT_SAMPLINGS[i])):
                    if not first:
                        first.append(time.monotonic() - t0)
                    last = o
                return list(last.token_ids)

            got = await asyncio.gather(*[one(i) for i in range(4)])
            await eng.stop()
            return t_up, got

        t_up, toks[mode] = asyncio.run(run())
        st = eng.stats()
        load = st["startup_weight_load_seconds"]
        rows[mode] = {"up_s": t_up, "first_token_s": first[0], "load_s": load,
                      "overlapped_s": st["startup_compile_seconds"],
                      "overlapped_share": st["startup_compile_seconds"] / load,
                      "warmup_s": st["startup_warmup_seconds"],
                      "phases": st["startup_phase_seconds"],
                      "deferred": st["startup_deferred_families"]}
        if not st["weights_ready"] or not st["startup_deferred_families"]:
            fail(f"ckpt overlap {mode}: weights ready {st['weights_ready']}, "
                 f"{st['startup_deferred_families']} deferred variants (the "
                 "manifest of the first boot was not found)")
        log(f"ckpt overlap {mode}: {json.dumps(rows[mode])}")
        eng.shutdown()
        del eng
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for mode in ("serial", "serial again"):
        if rows[mode]["overlapped_s"] != 0.0:
            fail(f"ckpt overlap: a serial load overlapped {rows[mode]}")
        if toks[mode] != toks["overlapped"]:
            fail(f"ckpt overlap: tokens of the overlapped load differ from the "
                 f"{mode} load's on streams "
                 f"{[i for i in range(4) if toks[mode][i] != toks['overlapped'][i]]}")
    return rows


# ------------------------------------------------------ phase 15: router
ROUTER_USERS = 4
ROUTER_ROUNDS = 3
ROUTER_TOKENS = 32                  # greedy tokens per round
ROUTER_FAILOVER_TOKENS = 128        # the stream cut by SIGKILL in round (d)
ROUTER_WATCHDOG_S = 600
ROUTER_HTTP_TIMEOUT_S = 120
DISAGG_REPEATS = 0                  # round (c) again (--disagg-repeats)
# benchmarks/multi_round_qa.py's synthetic text and its defaults.
QA_WORDS = ("the quick brown fox jumps over a lazy dog while curious engineers "
            "measure throughput latency and cache behavior of serving stacks").split()
QA_SYSTEM_WORDS = 120
QA_QUESTION_WORDS = 12


def qa_text(num_words, seed=0):
    """``benchmarks/multi_round_qa.py:synth_text``."""
    return " ".join(QA_WORDS[(seed + i) % len(QA_WORDS)] for i in range(max(1, num_words)))


def qa_system_prompt():
    return ("You are a helpful, knowledgeable assistant serving many users. "
            + qa_text(QA_SYSTEM_WORDS))


def qa_question(user, rnd, tag):
    """``multi_round_qa.UserSession._question``: the user, the pass's tag,
    the round, then filler."""
    return f"user {user} {tag} {rnd}: " + qa_text(QA_QUESTION_WORDS, seed=user * 31 + rnd)


def sse_request(url, body, headers, on_event=None, timeout=ROUTER_HTTP_TIMEOUT_S):
    """One streamed POST read event by event: (status, JSON events, t_sent,
    t_first event, t_end, ended in [DONE]). ``on_event(events)`` runs after
    each event (round (d) kills the serving engine from it)."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout)
    t0 = time.monotonic()
    try:
        conn.request("POST", parts.path, body=json.dumps(body), headers={
            "Content-Type": "application/json", **headers})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, [resp.read().decode()], t0, None, time.monotonic(), False
        events, t_first, done = [], None, False
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            if t_first is None:
                t_first = time.monotonic()
            payload = line[len("data: "):]
            if payload == "[DONE]":
                done = True
                continue
            events.append(json.loads(payload))
            if on_event is not None:
                on_event(events)
        return resp.status, events, t0, t_first, time.monotonic(), done
    finally:
        conn.close()


def event_tokens(events):
    """The token ids of a stream's pstpu payloads, checked contiguous."""
    toks = []
    for e in events:
        meta = e.get("pstpu")
        if meta is None:
            continue
        if meta["off"] != len(toks):
            fail(f"router: pstpu offsets not contiguous ({meta['off']} after "
                 f"{len(toks)} tokens)")
        toks += meta["toks"]
    return toks


def engine_kernels(url):
    st, _, text = request("GET", url + "/debug/kernels")
    if st != 200:
        fail(f"router: {url}/debug/kernels answered {st}")
    return json.loads(text)


def card_pids():
    """pids holding memory on the card, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    pids = {}
    for line in out.stdout.splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            pids[int(pid)] = mem.strip()
    return pids


def nvidia_files(pid):
    """The ``/dev/nvidia*`` device files a process holds open (CUDA's
    initialisation opens them), or None when /proc does not say."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return None
    out = []
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def router_off_card(name, router_pids, engine_pids):
    """No router process holds memory on the card (nvidia-smi's compute
    apps; this container may list no pid there, so the engines' are counted
    beside), nor holds any ``/dev/nvidia*`` file open (it never initialised
    CUDA; the engines' open files are counted beside, showing the check
    sees a process that did)."""
    on = card_pids()
    bad = {p: on[p] for p in router_pids if p in on}
    if bad:
        fail(f"router {name}: the router process holds memory on the card: {bad}")
    files = {p: nvidia_files(p) for p in router_pids}
    if any(f is None or f for f in files.values()):
        fail(f"router {name}: the router process has /dev/nvidia files open (or "
             f"/proc does not say): {files}")
    return {"router_pids_on_card": 0, "router_nvidia_files": 0,
            "engine_pids_listed": sum(p in on for p in engine_pids),
            "engine_nvidia_files": [len(nvidia_files(p) or []) for p in engine_pids]}


def median(xs):
    xs = sorted(xs)
    return None if not xs else (xs[len(xs) // 2] if len(xs) % 2
                                else (xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2)


def stream_times(sent, first, end, n_tokens):
    return first - sent, 1e3 * (end - first) / max(1, n_tokens - 1)


def router_chat_round(name, router_url, engines, model, n_layers, variant):
    """``ROUTER_USERS`` users x ``ROUTER_ROUNDS`` rounds of multi-round chat
    (``benchmarks/multi_round_qa.py``'s shape: a shared system prompt, each
    user's history, the answer, a new question), streamed, greedy, one
    request at a time through ``router_url``. For each request: the
    engine that served it (its ``/debug/requests/{id}``), the prefix-cache
    hits it added there (rounds 2 and 3 must hit), then the same request
    straight to that engine and through the router again: those two find
    the same prefix-cache state (the whole prompt cached), so their tokens
    must be equal. Each engine's kernel counter must grow by layers x its
    decode steps. Returns (launches, summary row, user -> engine)."""
    for url in engines:
        request("POST", url + "/debug/kernels/reset")
    before = {url: engine_kernels(url)["stats"] for url in engines}
    convs = [[{"role": "system", "content": qa_system_prompt()}]
             for _ in range(ROUTER_USERS)]
    where_of, rows, routed_t, direct_t = {}, [], [], []
    for rnd in range(ROUTER_ROUNDS):
        for u in range(ROUTER_USERS):
            msgs = convs[u] + [{"role": "user", "content": qa_question(u, rnd, name)}]
            body = {"model": model, "messages": msgs, "temperature": 0,
                    "max_tokens": ROUTER_TOKENS, "ignore_eos": True, "stream": True,
                    "stream_options": {"include_usage": True}}
            rid = f"{name}-u{u}-r{rnd}"
            user = {"x-user-id": f"user-{u}"}
            hits0 = {url: engine_kernels(url)["stats"]["prefix_cache_hits"]
                     for url in engines}
            st, evs, t0, tf, te, done = sse_request(
                router_url + "/v1/chat/completions", body, {**user, "x-request-id": rid})
            toks = event_tokens(evs)
            if st != 200 or not done or len(toks) != ROUTER_TOKENS:
                fail(f"router {name} {rid}: HTTP {st}, [DONE] {done}, {len(toks)} tokens")
            served = [url for url in engines
                      if request("GET", f"{url}/debug/requests/{rid}")[0] == 200]
            if len(served) != 1:
                fail(f"router {name} {rid}: served by {served}")
            where = served[0]
            if where_of.setdefault(u, where) != where:
                fail(f"router {name}: user {u}'s round {rnd} went to {where}, its "
                     f"earlier rounds to {where_of[u]}")
            hits = engine_kernels(where)["stats"]["prefix_cache_hits"] - hits0[where]
            if rnd > 0 and hits <= 0:
                fail(f"router {name} {rid}: no prefix-cache hit on {where} in round "
                     f"{rnd + 1}")
            st_d, evs_d, d0, df, de, done_d = sse_request(
                where + "/v1/chat/completions", body,
                {"x-request-id": rid + "-direct", "x-pstpu-resume": "1"})
            st_r, evs_r, r0, rf, re_, done_r = sse_request(
                router_url + "/v1/chat/completions", body,
                {**user, "x-request-id": rid + "-again"})
            toks_d, toks_r = event_tokens(evs_d), event_tokens(evs_r)
            if (st_d, st_r, done_d, done_r) != (200, 200, True, True) or toks_r != toks_d:
                first = next((i for i, (a, b) in enumerate(zip(toks_r, toks_d)) if a != b),
                             None)
                fail(f"router {name} {rid}: routed tokens differ from the same request "
                     f"straight to {where} (HTTP {st_r}/{st_d}, first difference at "
                     f"{first}, {len(toks_r)} vs {len(toks_d)} tokens)")
            if request("GET", f"{where}/debug/requests/{rid}-again")[0] != 200:
                fail(f"router {name} {rid}: the routed twin left {where}")
            routed_t.append(stream_times(r0, rf, re_, len(toks_r)))
            direct_t.append(stream_times(d0, df, de, len(toks_d)))
            rows.append({"rid": rid, "engine": engines.index(where), "hits": hits,
                         "first_equal_twin": toks == toks_d})
            text = "".join(e["choices"][0]["delta"].get("content", "")
                           for e in evs if e.get("choices"))
            convs[u] = msgs + [{"role": "assistant", "content": text}]
    launches, steps = {}, {}
    for url in engines:
        k = engine_kernels(url)
        steps[url] = k["stats"]["decode_steps_total"] - before[url]["decode_steps_total"]
        launches[url] = k["launch_counts"].get(variant, 0)
        eager = (k["stats"]["decode_eager_dispatches_total"]
                 - before[url]["decode_eager_dispatches_total"])
        if launches[url] != n_layers * steps[url] or eager:
            fail(f"router {name}: {url} launched {k['launch_counts']} for {steps[url]} "
                 f"decode steps ({n_layers} layers), {eager} eager dispatches")
    if not any(steps.values()):
        fail(f"router {name}: no decode step on either engine")
    row = {"requests": len(rows) * 3, "users_per_engine": [
        sum(1 for w in where_of.values() if w == url) for url in engines],
        "prefix_hits_rounds_2_3": [r["hits"] for r in rows[ROUTER_USERS:]],
        "decode_steps": [steps[u] for u in engines],
        "launches": [launches[u] for u in engines],
        "first_pass_equal_twin": sum(r["first_equal_twin"] for r in rows),
        "ttft_ms_median": {"router": 1e3 * median([t for t, _ in routed_t]),
                           "direct": 1e3 * median([t for t, _ in direct_t])},
        "itl_ms_median": {"router": median([i for _, i in routed_t]),
                          "direct": median([i for _, i in direct_t])}}
    log(f"router {name}: {json.dumps(row)}")
    return sum(launches.values()), row, {u: engines.index(w) for u, w in where_of.items()}


def router_metrics_check(name, router_url, engines):
    """The router's /metrics: every family of the port's router metrics
    (the JAX router's families, tests/test_torch_router_parity.py), and
    both engines' scraped gauges under ``server``."""
    from production_stack_tpu_torch.router import metrics as rmetrics

    st, _, text = request("GET", router_url + "/metrics")
    have = {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE ")}
    want = {f.name + ("_total" if f.kind == "counter" else "") for f in rmetrics._FAMILIES}
    if st != 200 or want - have:
        fail(f"router {name}: /metrics {st}, families missing {sorted(want - have)}")
    deadline = time.monotonic() + 30
    while True:
        series = parse_metrics(request("GET", router_url + "/metrics")[2])
        servers = {lab.get("server") for lab, _ in series.get("vllm:num_requests_running", [])}
        if set(engines) <= servers:
            break
        if time.monotonic() > deadline:
            fail(f"router {name}: engines {engines} not all under server= in "
                 f"vllm:num_requests_running ({servers})")
        time.sleep(0.5)
    return len(have)


def router_disagg_round(torch, pa, pd, model, kv_url, kv_cache_dtype, hand, n_layers):
    """Round (c): the port's router with ``--routing-logic disagg`` in front
    of the kvtier phase's prefill/decode pair; the 4 chats ``kvtier_disagg``
    drove by hand, through it: tokens equal the hand-driven hops', the
    decode engine replays its graphs (its kernel count layers x its decode
    steps), the router counts 4 handoffs and no fallback, and its process
    holds no memory on the card. Returns (launches, summary row)."""
    from production_stack_tpu_torch.launch import launch_router

    pre, dec = pd.urls
    router = launch_router(pd.urls, [model], [
        "--routing-logic", "disagg", "--static-backend-roles", "prefill,decode",
        "--kv-offload-url", kv_url, "--session-key", "x-user-id",
        "--engine-stats-interval", "1"], os.path.dirname(DETAIL_LOG))
    try:
        request("POST", dec + "/debug/kernels/reset")
        d0 = engine_kernels(dec)["stats"]
        ttft, toks = [], []
        for i, body in enumerate(hand["bodies"]):
            st, evs, t0, tf, te, done = sse_request(
                router.url + "/v1/chat/completions", body,
                {"x-user-id": f"disagg-{i}", "x-request-id": f"router-disagg-{kv_cache_dtype}-{i}"})
            got = event_tokens(evs)
            if st != 200 or not done or got != hand["tokens"][i]:
                # Both engines' timelines of this chat, routed and by hand:
                # where the two runs parted (a restore, a chunk, a batch).
                for u in pd.urls:
                    for rid in (f"router-disagg-{kv_cache_dtype}-{i}",
                                f"pstpu-transfer:kvtier-{kv_cache_dtype}-{i}"):
                        log(f"router disagg {kv_cache_dtype} chat {i}: {rid} on {u}: "
                            f"{request('GET', f'{u}/debug/requests/{rid}')[2]}")
                fail(f"router disagg {kv_cache_dtype} chat {i}: HTTP {st}, [DONE] {done}, "
                     f"tokens differ from the hand-driven hops' at "
                     f"{next((j for j, (a, b) in enumerate(zip(got, hand['tokens'][i])) if a != b), None)}"
                     f" ({len(got)} vs {len(hand['tokens'][i])})")
            ttft.append(tf - t0)
            toks.append(len(got))
        k = engine_kernels(dec)
        restored = engine_kernels(pre)["stats"]["kv_restore_saved_tokens_total"]
        if restored:
            fail(f"router disagg {kv_cache_dtype}: the prefill engine restored "
                 f"{restored} tokens (every hop 1 prefills cold)")
        steps = k["stats"]["decode_steps_total"] - d0["decode_steps_total"]
        eager = k["stats"]["decode_eager_dispatches_total"] - d0["decode_eager_dispatches_total"]
        variant = pa.INT8 if kv_cache_dtype == "int8" else pa.BF16
        launches = k["launch_counts"].get(variant, 0)
        if launches != n_layers * steps or not steps or eager:
            fail(f"router disagg {kv_cache_dtype}: decode engine launched "
                 f"{k['launch_counts']} for {steps} decode steps, {eager} eager")
        series = parse_metrics(request("GET", router.url + "/metrics")[2])
        handoffs = sum(v for _, v in series.get("router_disagg_handoffs_total", []))
        fallbacks = sum(v for _, v in series.get("router_disagg_fallbacks_total", []))
        if handoffs != len(hand["bodies"]) or fallbacks:
            fail(f"router disagg {kv_cache_dtype}: {handoffs} handoffs, {fallbacks} "
                 "fallbacks")
        off = router_off_card(f"disagg {kv_cache_dtype}", [router.proc.pid],
                              [p.pid for p in pd.procs])
        repeats = router_disagg_repeats(router.url, pd.urls, hand, kv_cache_dtype)
    finally:
        router.stop()
    row = {"requests": len(toks), "tokens_equal_hand_driven": True, "decode_steps": steps,
           "decode_launches": launches, "handoffs": handoffs, "repeats": repeats,
           "ttft_ms_median": {"router": 1e3 * median(ttft),
                              "hand": 1e3 * median(hand["ttft_s"])}, **off}
    log(f"router disagg {kv_cache_dtype}: {json.dumps(row)}")
    return launches, row


def router_disagg_repeats(router_url, urls, hand, kv_cache_dtype):
    """Round (c)'s chats sent ``DISAGG_REPEATS`` more times (``--disagg-repeats``;
    0 in a whole run), each through the same router and by hand (both hops
    again), every one held to the first hand-driven hops' tokens; a chat
    that differs is logged with both engines' timelines of it, and the run
    fails after the last repeat."""
    differ = []
    for r in range(DISAGG_REPEATS):
        for i, body in enumerate(hand["bodies"]):
            rid = f"router-disagg-{kv_cache_dtype}-r{r}-{i}"
            st, evs, *_ = sse_request(router_url + "/v1/chat/completions", body,
                                      {"x-user-id": f"disagg-{i}", "x-request-id": rid})
            key = f"pstpu-transfer:repeat-{kv_cache_dtype}-{r}-{i}"
            runs = (("router", rid, st, event_tokens(evs)),
                    ("hand", key, 200, disagg_hops(*urls, body, key)[1]))
            for how, req_id, status, got in runs:
                if status == 200 and got == hand["tokens"][i]:
                    continue
                at = next((j for j, (a, b) in enumerate(zip(got, hand["tokens"][i]))
                           if a != b), None)
                differ.append({"repeat": r, "chat": i, "how": how, "status": status,
                               "at": at, "got": got, "want": hand["tokens"][i]})
                for u in urls:
                    log(f"router disagg repeat {r} chat {i} ({how}) on {u}: "
                        f"{request('GET', f'{u}/debug/requests/{req_id}')[2]}")
    row = {"runs": DISAGG_REPEATS, "chats": 2 * DISAGG_REPEATS * len(hand["bodies"]),
           "differ": [{k: d[k] for k in ("repeat", "chat", "how", "status", "at")}
                      for d in differ]}
    log(f"router disagg {kv_cache_dtype} repeats: {json.dumps(row)} {json.dumps(differ)}")
    if differ:
        fail(f"router disagg {kv_cache_dtype}: {len(differ)} of {row['chats']} repeated "
             f"chats differ from the hand-driven hops': {row['differ']}")
    return row


def router_failover(name, router_url, router_log, engines, pids, model, where_of, tag):
    """Round (d), last: a stream of the session router's whose engine is
    SIGKILLed after its first event. The client must get one whole stream
    of ``ROUTER_FAILOVER_TOKENS`` tokens with a finish reason and no 5xx;
    the tokens after the cut must equal the survivor's greedy continuation
    of the prompt plus the delivered tokens, sent straight to it; the router
    counts one resume, and the dead backend's breaker opens. Before the
    stream the survivor is primed with the prompt plus the doomed engine's
    own answer, so the routed resume and its direct twin find the same
    prefix-cache state. Returns (the survivor's launches, summary row)."""
    u = 0
    a = engines[where_of[u]]
    b = next(url for url in engines if url != a)
    body = {"model": model, "temperature": 0, "max_tokens": ROUTER_FAILOVER_TOKENS,
            "ignore_eos": True, "stream": True, "messages": [
                {"role": "system", "content": qa_system_prompt()},
                {"role": "user", "content": qa_question(u, 0, tag)}]}
    resume = {"x-pstpu-resume": "1"}
    answers = []
    for i in range(2):
        st, evs, *_ = sse_request(a + "/v1/chat/completions", body,
                                  {**resume, "x-request-id": f"{name}-warm-{i}"})
        answers.append(event_tokens(evs))
    st, evs, *_ = sse_request(b + "/v1/chat/completions",
                              {**body, "resume_tokens": answers[1][:-1]},
                              {**resume, "x-request-id": f"{name}-prime"})
    if st != 200:
        fail(f"router {name}: priming {b} answered {st}")
    request("POST", b + "/debug/kernels/reset")
    b0 = engine_kernels(b)["stats"]
    victim = pids[engines.index(a)]
    killed = []

    def on_event(events):
        if not killed and event_tokens(events):
            os.kill(victim, signal.SIGKILL)
            killed.append(time.monotonic())

    rid = f"{name}-failover"
    st, evs, t0, tf, te, done = sse_request(
        router_url + "/v1/chat/completions", body,
        {"x-user-id": f"user-{u}", "x-request-id": rid}, on_event=on_event)
    toks = event_tokens(evs)
    finish = [c.get("finish_reason") for e in evs for c in e.get("choices", [])
              if c.get("finish_reason")]
    if st != 200 or not done or len(toks) != ROUTER_FAILOVER_TOKENS or finish != ["length"]:
        fail(f"router {name}: the cut stream ended HTTP {st}, [DONE] {done}, "
             f"{len(toks)} tokens, finish {finish}")
    cut = None
    deadline = time.monotonic() + 10
    while cut is None and time.monotonic() < deadline:
        for line in open(router_log, errors="replace"):
            if f"Request {rid} resumed on" in line:
                cut = int(line.rsplit("token offset", 1)[1].split()[0])
        time.sleep(0.2)
    if cut is None or not 0 < cut < ROUTER_FAILOVER_TOKENS:
        fail(f"router {name}: no resume of {rid} in the router's log (cut {cut})")
    st, evs_d, *_ = sse_request(b + "/v1/chat/completions",
                                {**body, "resume_tokens": toks[:cut]},
                                {**resume, "x-request-id": rid + "-direct"})
    rest = []
    for e in evs_d:
        if "pstpu" in e:
            rest += e["pstpu"]["toks"]
    if st != 200 or toks[cut:] != rest:
        fail(f"router {name}: tokens after the cut ({cut}) differ from {b}'s greedy "
             f"continuation (first difference at "
             f"{next((j for j, (x, y) in enumerate(zip(toks[cut:], rest)) if x != y), None)}, "
             f"{len(toks) - cut} vs {len(rest)} tokens)")
    series = parse_metrics(request("GET", router_url + "/metrics")[2])
    resumed = sum(v for lab, v in series.get("router_midstream_resumes_total", [])
                  if lab.get("outcome") == "resumed")
    if resumed != 1:
        fail(f"router {name}: router_midstream_resumes_total resumed = {resumed}")
    follow, state = 0, None
    while follow < 40:
        follow += 1
        st, *_ = sse_request(router_url + "/v1/chat/completions",
                             {**body, "max_tokens": 4},
                             {"x-user-id": f"user-{u}", "x-request-id": f"{rid}-after-{follow}"})
        if st != 200:
            fail(f"router {name}: request {follow} after the kill answered {st}")
        state = json.loads(request("GET", router_url + "/health")[2]).get(
            "circuit_breakers", {}).get(a)
        if state == "open":
            break
    if state != "open":
        fail(f"router {name}: {a}'s breaker is {state} after {follow} requests")
    k = engine_kernels(b)
    row = {"cut_at": cut, "tokens": len(toks), "kill_to_end_ms": 1e3 * (te - killed[0]),
           "delivered_equal_warm_answer": toks[:cut] == answers[1][:cut],
           "resumes": resumed, "requests_to_open": follow,
           "survivor_decode_steps": k["stats"]["decode_steps_total"] - b0["decode_steps_total"]}
    log(f"router {name} failover: {json.dumps(row)}")
    return k, row


FEATURE_TOKENS = 16                 # greedy tokens per request, rounds (e)-(f)
FEATURE_BATCH_LINES = 4
FAKE_KUBE_PEM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                             "fake_kube_api.pem")
KUBE_GROUP = "/apis/production-stack.tpu/v1alpha1"


class FakeKubeApi:
    """Just enough of the Kubernetes REST API, on the standard library, for
    the router's pod discovery and the two controllers: pods LIST and WATCH
    (each open watch a queue of events, written as chunks), StaticRoutes
    and LoraAdapters listed with their status PATCHes kept, ConfigMaps
    GET / POST / PUT, Services GET. ``tls`` serves HTTPS (a throwaway
    self-signed certificate for 127.0.0.1, ``tests/fake_kube_api.pem``):
    the router finds its API server at the in-cluster https endpoint."""

    def __init__(self, tls=False):
        import http.server
        import queue
        import re
        import ssl
        from urllib.parse import parse_qs, urlsplit

        self.pods, self.rv = {}, 100
        self.staticroutes, self.loraadapters = {}, {}
        self.configmaps, self.services = {}, {}
        self.patches, self.lists, self.watches = [], [], []
        self.watchers = []
        self.lock = threading.Lock()
        api = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _send(self, status, obj):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n)) if n else None

            def do_GET(self):
                parts = urlsplit(self.path)
                path, q = parts.path, {k: v[0] for k, v in parse_qs(parts.query).items()}
                m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/pods", path)
                if m and q.get("watch") == "true":
                    return self._watch(q)
                if m:
                    with api.lock:
                        api.lists.append(q)
                        api.rv += 1
                        body = {"metadata": {"resourceVersion": str(api.rv)},
                                "items": list(api.pods.values())}
                    return self._send(200, body)
                m = re.fullmatch(KUBE_GROUP + r"/namespaces/([^/]+)/(staticroutes|"
                                 r"loraadapters)", path)
                if m:
                    kind = getattr(api, m.group(2))
                    return self._send(200, {"items": [o for (ns, _), o in kind.items()
                                                      if ns == m.group(1)]})
                m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/(configmaps|services)/"
                                 r"([^/]+)", path)
                if m:
                    obj = getattr(api, m.group(2)).get((m.group(1), m.group(3)))
                    return self._send(*((200, obj) if obj is not None
                                        else (404, {"kind": "Status", "code": 404})))
                self._send(404, {"kind": "Status", "code": 404})

            def _watch(self, q):
                api.watches.append(q)
                events = queue.Queue()
                api.watchers.append(events)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                deadline = time.monotonic() + float(q.get("timeoutSeconds", 30))
                try:
                    while True:
                        try:
                            ev = events.get(timeout=max(0.0, deadline - time.monotonic()))
                        except queue.Empty:
                            ev = None
                        if ev is None:
                            break
                        line = json.dumps(ev).encode() + b"\n"
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(line), line))
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass
                finally:
                    api.watchers.remove(events)
                self.close_connection = True

            def do_POST(self):
                m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/configmaps", self.path)
                if not m:
                    return self._send(404, {"kind": "Status", "code": 404})
                body = self._body()
                api.configmaps[(m.group(1), body["metadata"]["name"])] = body
                self._send(201, body)

            def do_PUT(self):
                m = re.fullmatch(r"/api/v1/namespaces/([^/]+)/configmaps/([^/]+)",
                                 self.path)
                if not m:
                    return self._send(404, {"kind": "Status", "code": 404})
                body = self._body()
                api.configmaps[(m.group(1), m.group(2))] = body
                self._send(200, body)

            def do_PATCH(self):
                m = re.fullmatch(KUBE_GROUP + r"/namespaces/([^/]+)/(staticroutes|"
                                 r"loraadapters)/([^/]+)/status", self.path)
                if not m or self.headers.get("Content-Type") != \
                        "application/merge-patch+json":
                    return self._send(404, {"kind": "Status", "code": 404})
                api.patches.append((m.group(2), m.group(3), self._body()["status"]))
                self._send(200, {"ok": True})

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        if tls:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(FAKE_KUBE_PEM)
            self.server.socket = ctx.wrap_socket(self.server.socket, server_side=True)
        self.port = self.server.server_address[1]
        self.url = f"{'https' if tls else 'http'}://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def push(self, etype, pod):
        for q in list(self.watchers):
            q.put({"type": etype, "object": pod})

    def status_of(self, kind, name):
        return next((st for k, n, st in reversed(self.patches)
                     if k == kind and n == name), None)

    def close(self):
        for q in list(self.watchers):
            q.put(None)
        self.server.shutdown()
        self.server.server_close()


def kube_pod(name, ready):
    """A pod at 127.0.0.1 labelled ``app=pstpu-engine``."""
    return {"metadata": {"name": name, "labels": {"app": "pstpu-engine"}},
            "status": {"podIP": "127.0.0.1",
                       "containerStatuses": [{"ready": ready}]}}


def start_controller(module, api_url, log_dir, *extra):
    """``python -m production_stack_tpu_torch.controller[.lora_main]``, a
    CPU process, against ``api_url``; its log beside the router's."""
    here = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(log_dir, f"{module.rsplit('.', 1)[-1]}.log"), "w")
    env = dict(os.environ, PYTHONPATH=here)
    proc = subprocess.Popen([sys.executable, "-m", module, "--api-base", api_url,
                             "--namespace", "default", *extra],
                            stdout=log, stderr=subprocess.STDOUT, cwd=here, env=env)
    log.close()
    return proc


def wait_for(what, pred, timeout_s, poll_s=0.05):
    """Poll ``pred`` until it is true (returns seconds waited) or fail."""
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout_s:
            fail(f"router: {what} not within {timeout_s} s")
        time.sleep(poll_s)
    return time.monotonic() - t0


def multipart_body(fields):
    """``multipart/form-data`` of ``fields`` [(name, bytes, filename or
    None)]: (content type, body)."""
    boundary = f"pstpu-{random.getrandbits(64):016x}"
    out = b""
    for name, data, filename in fields:
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"'
                                              if filename else "")
        out += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n").encode() \
            + data + b"\r\n"
    return f"multipart/form-data; boundary={boundary}", out + f"--{boundary}--\r\n".encode()


def post_raw(url, data, ctype, timeout=ROUTER_HTTP_TIMEOUT_S):
    import urllib.error

    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def stream_logprobs(events):
    """(token strings, logprobs) of a streamed chat's logprobs entries."""
    toks, lps = [], []
    for e in events:
        for c in e.get("choices", []):
            for entry in ((c.get("logprobs") or {}).get("content") or []):
                toks.append(entry["token"])
                lps.append(entry["logprob"])
    return toks, lps


def served_by(engines, rid):
    where = [u for u in engines if request("GET", f"{u}/debug/requests/{rid}")[0] == 200]
    if len(where) != 1:
        fail(f"router: {rid} served by {where}")
    return where[0]


def feature_prompt(tag, i):
    return f"{tag} {i}: " + qa_text(48, seed=7 * i + len(tag))


def prime(engines, body, whole=False):
    """The body's prompt once on each engine (one token; ``whole``: the
    request as it is, not streamed), so a request and its twin after it
    find the same prefix-cache state."""
    for url in engines:
        st, _, _ = request("POST", url + "/v1/chat/completions", {**body, "stream": False} if whole
                           else {**body, "stream": False, "max_tokens": 1, "logprobs": False})
        if st != 200:
            fail(f"router: priming {url} answered {st}")


def feature_batch_bodies(model):
    """Round (e)'s batch lines: greedy chats of ``FEATURE_TOKENS`` tokens
    with logprobs (their token strings and logprobs stand for the token ids
    a non-streamed response does not carry)."""
    return [{"model": model, "temperature": 0, "max_tokens": FEATURE_TOKENS,
             "ignore_eos": True, "logprobs": True, "messages": [
                 {"role": "user", "content": feature_prompt("batch line", i)}]}
            for i in range(FEATURE_BATCH_LINES)]


def router_gated_round(model, engines, pids, log_dir, bodies):
    """Round (e): a router with the batch API, PII redaction and the
    semantic cache in front of both engines (see the module docstring),
    ``bodies`` its batch lines, primed on both engines. Returns its summary
    row."""
    from production_stack_tpu_torch.launch import launch_router

    t_round = time.monotonic()
    store = tempfile.mkdtemp(prefix="files-", dir=log_dir)
    gated = launch_router(engines, [model], [
        "--routing-logic", "roundrobin", "--enable-batch-api", "--file-storage-path",
        store, "--feature-gates", "SemanticCache=true,PIIDetection=true",
        "--pii-action", "redact", "--engine-stats-interval", "1"], log_dir)
    blocker = None
    row = {"router_up_s": time.monotonic() - t_round}
    try:
        # batch: each output line must equal its twin straight to an engine
        jsonl = "\n".join(json.dumps({"custom_id": f"line-{i}", "method": "POST",
                                      "url": "/v1/chat/completions", "body": b})
                          for i, b in enumerate(bodies)).encode()
        ctype, data = multipart_body([("file", jsonl, "batch.jsonl"),
                                      ("purpose", b"batch", None)])
        st, text = post_raw(gated.url + "/v1/files", data, ctype)
        if st != 200:
            fail(f"router gated: upload answered {st}: {text[:200]}")
        upload = json.loads(text)
        t0 = time.monotonic()
        st, _, text = request("POST", gated.url + "/v1/batches", {
            "input_file_id": upload["id"], "endpoint": "/v1/chat/completions"})
        batch = json.loads(text)
        if st != 200 or batch["status"] != "validating":
            fail(f"router gated: batch create answered {st}: {text[:200]}")

        def completed():
            nonlocal batch
            batch = json.loads(request("GET", f"{gated.url}/v1/batches/{batch['id']}")[2])
            return batch["status"] in ("completed", "failed", "cancelled")

        wait_for("the batch's completion", completed, 120, poll_s=0.2)
        row["batch_s"] = time.monotonic() - t0
        if batch["status"] != "completed" or batch["request_counts"] != {
                "total": FEATURE_BATCH_LINES, "completed": FEATURE_BATCH_LINES, "failed": 0}:
            fail(f"router gated: batch ended {batch['status']} {batch['request_counts']}")
        st, _, out = request("GET", f"{gated.url}/v1/files/{batch['output_file_id']}/content")
        lines = [json.loads(ln) for ln in out.splitlines()]
        equal_both = 0
        for i, (b, line) in enumerate(zip(bodies, lines)):
            resp = line["response"]["body"]
            got = [(e["token"], e["logprob"]) for e in
                   resp["choices"][0]["logprobs"]["content"]]
            twins = []
            for url in engines:
                st, evs, *_ = sse_request(url + "/v1/chat/completions", {**b, "stream": True},
                                          {"x-pstpu-resume": "1",
                                           "x-request-id": f"batch-twin-{i}-{engines.index(url)}"})
                toks, lps = stream_logprobs(evs)
                twins.append((event_tokens(evs), list(zip(toks, lps))))
            if line["custom_id"] != f"line-{i}" or len(got) != FEATURE_TOKENS or \
                    got not in [t[1] for t in twins]:
                fail(f"router gated: batch line {i}'s tokens and logprobs differ from "
                     f"both engines' twins (first difference at "
                     f"{[next((j for j, (x, y) in enumerate(zip(got, t[1])) if x != y), None) for t in twins]})")
            equal_both += twins[0] == twins[1]
        row["batch_lines_equal_a_twin"] = len(lines)
        row["batch_twins_equal_across_engines"] = equal_both
        # PII: the routed stream with an email equals its redacted twin
        text = feature_prompt("pii", 0)
        email = {"model": model, "temperature": 0, "max_tokens": FEATURE_TOKENS,
                 "ignore_eos": True, "stream": True, "messages": [
                     {"role": "user", "content": f"mail bob@example.com: {text}"}]}
        redacted = {**email, "messages": [
            {"role": "user", "content": f"mail [REDACTED:email]: {text}"}]}
        prime(engines, redacted)
        st, evs, *_ = sse_request(gated.url + "/v1/chat/completions", email,
                                  {"x-request-id": "pii-routed"})
        where = served_by(engines, "pii-routed")
        st_d, evs_d, *_ = sse_request(where + "/v1/chat/completions", redacted,
                                      {"x-pstpu-resume": "1", "x-request-id": "pii-twin"})
        toks, toks_d = event_tokens(evs), event_tokens(evs_d)
        if (st, st_d) != (200, 200) or len(toks) != FEATURE_TOKENS or toks != toks_d:
            fail(f"router gated: the redacted request's tokens differ from its twin's "
                 f"(HTTP {st}/{st_d}, {len(toks)} vs {len(toks_d)} tokens)")
        row["pii_tokens_equal_redacted_twin"] = True
        # the semantic cache: the second of two equal chats is a hit that
        # launches nothing
        chat = {"model": model, "temperature": 0, "max_tokens": FEATURE_TOKENS,
                "ignore_eos": True, "messages": [
                    {"role": "user", "content": feature_prompt("cache", 0)}]}
        st1, _, first = request("POST", gated.url + "/v1/chat/completions", chat)
        k0 = {u: engine_kernels(u) for u in engines}
        t0 = time.monotonic()
        st2, _, second = request("POST", gated.url + "/v1/chat/completions", chat)
        row["cache_hit_ms"] = 1e3 * (time.monotonic() - t0)
        k1 = {u: engine_kernels(u) for u in engines}
        first, second = json.loads(first), json.loads(second)
        moved = [u for u in engines if k1[u]["launch_counts"] != k0[u]["launch_counts"]
                 or k1[u]["stats"]["decode_steps_total"] != k0[u]["stats"]["decode_steps_total"]]
        if (st1, st2) != (200, 200) or "cached" in first or \
                second != {**first, "cached": True} or moved:
            fail(f"router gated: cache round HTTP {st1}/{st2}, cached "
                 f"{second.get('cached')}, kernel counts moved on {moved}")
        series = parse_metrics(request("GET", gated.url + "/metrics")[2])
        hits = sum(v for _, v in series.get("vllm:semantic_cache_hits_total", []))
        misses = sum(v for _, v in series.get("vllm:semantic_cache_misses_total", []))
        scanned = sum(v for _, v in series.get("vllm:pii_requests_scanned_total", []))
        if (hits, misses) != (1, 1):
            fail(f"router gated: semantic cache hits {hits}, misses {misses}")
        row.update(cache_hits=hits, cache_misses=misses, pii_scanned=scanned)
        # PII block: a second router answers 400 pii_detected
        blocker = launch_router(engines, [model], [
            "--feature-gates", "PIIDetection=true", "--engine-stats-interval", "1"],
            log_dir)
        st, _, text = request("POST", blocker.url + "/v1/chat/completions",
                              {**email, "stream": False})
        err = json.loads(text).get("error", {})
        if st != 400 or err.get("type") != "pii_detected":
            fail(f"router gated: block mode answered {st}: {text[:200]}")
        row["pii_block_status"] = st
        row.update(router_off_card("gated", [gated.proc.pid, blocker.proc.pid], pids))
    finally:
        gated.stop()
        if blocker is not None:
            blocker.stop()
        shutil.rmtree(store, ignore_errors=True)
    row["seconds"] = time.monotonic() - t_round
    log(f"router gated: {json.dumps(row)}")
    return row


def router_k8s_round(model, engines, pids, log_dir):
    """Round (f): a router with ``--service-discovery k8s`` finds a ready
    pod (the fake API server's, at the in-cluster HTTPS endpoint) on the
    second engine's port, serves a chat equal to its twin straight to the
    engine, and drops the pod when it turns unready."""
    from production_stack_tpu_torch.launch import launch_router

    t_round = time.monotonic()
    target = engines[1]
    port = target.rsplit(":", 1)[1]
    api = FakeKubeApi(tls=True)
    api.pods["engine-1"] = kube_pod("engine-1", True)
    saved = {k: os.environ.get(k) for k in ("KUBERNETES_SERVICE_HOST",
                                            "KUBERNETES_SERVICE_PORT")}
    os.environ.update(KUBERNETES_SERVICE_HOST="127.0.0.1",
                      KUBERNETES_SERVICE_PORT=str(api.port))
    router = None
    row = {}
    try:
        router = launch_router(engines[:1], [model], [
            "--service-discovery", "k8s", "--k8s-namespace", "default",
            "--k8s-port", port, "--k8s-label-selector", "app=pstpu-engine",
            "--engine-stats-interval", "1"], log_dir)
        row["router_up_s"] = time.monotonic() - t_round

        def models():
            return [m["id"] for m in json.loads(
                request("GET", router.url + "/v1/models")[2])["data"]]

        row["discovered_s"] = wait_for("k8s discovery of the ready pod",
                                       lambda: models() == [model], 10)
        body = {"model": model, "temperature": 0, "max_tokens": FEATURE_TOKENS,
                "ignore_eos": True, "stream": True, "messages": [
                    {"role": "user", "content": feature_prompt("k8s", 0)}]}
        prime([target], body)
        st, evs, *_ = sse_request(router.url + "/v1/chat/completions", body,
                                  {"x-request-id": "k8s-routed"})
        where = served_by(engines, "k8s-routed")
        st_d, evs_d, *_ = sse_request(target + "/v1/chat/completions", body,
                                      {"x-pstpu-resume": "1", "x-request-id": "k8s-twin"})
        toks, toks_d = event_tokens(evs), event_tokens(evs_d)
        if where != target or (st, st_d) != (200, 200) or len(toks) != FEATURE_TOKENS \
                or toks != toks_d:
            fail(f"router k8s: served by {where} (want {target}), HTTP {st}/{st_d}, "
                 f"tokens equal {toks == toks_d}")
        wait_for("the watch stream", lambda: api.watchers, 10, poll_s=0.02)
        api.push("MODIFIED", kube_pod("engine-1", False))
        row["removed_s"] = wait_for("the unready pod's removal", lambda: models() == [], 5)
        st, _, _ = request("POST", router.url + "/v1/chat/completions",
                           {**body, "stream": False})
        if st != 404:
            fail(f"router k8s: a chat with no backend answered {st} (the JAX "
                 "router's 404)")
        row.update(lists=len(api.lists), watch_resource_version=api.watches[0].get(
            "resourceVersion"), label_selector=api.lists[0].get("labelSelector"),
            tokens_equal_twin=True, no_backend_status=st,
            **router_off_card("k8s", [router.proc.pid], pids))
    finally:
        if router is not None:
            router.stop()
        api.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    row["seconds"] = time.monotonic() - t_round
    log(f"router k8s: {json.dumps(row)}")
    return row


def router_operator_round(model, engines, pids, log_dir):
    """Round (g), the operator: a router on the first engine watching
    ``dynamic_config.json``; the StaticRoute operator (a process) renders a
    CR naming the second engine into its ConfigMap, probes the router's
    health through the CR's Service, patches the CR's status; the
    ConfigMap's file, written where the router reads it (the kubelet's
    part), re-points the router: a chat lands on the second engine."""
    from production_stack_tpu_torch.launch import launch_router

    t_round = time.monotonic()
    cfg = os.path.join(log_dir, "dynamic_config.json")
    if os.path.exists(cfg):
        os.remove(cfg)
    router = launch_router(engines[:1], [model], [
        "--dynamic-config-json", cfg, "--dynamic-config-watch-interval", "0.5",
        "--engine-stats-interval", "1"], log_dir)
    api = FakeKubeApi()
    operator = None
    row = {"router_up_s": time.monotonic() - t_round}
    try:
        api.services[("default", "router-svc")] = {"spec": {
            "clusterIP": "127.0.0.1", "ports": [{"port": int(router.url.rsplit(":", 1)[1])}]}}
        api.staticroutes[("default", "route-a")] = {
            "apiVersion": "production-stack.tpu/v1alpha1", "kind": "StaticRoute",
            "metadata": {"name": "route-a", "namespace": "default", "uid": "uid-a"},
            "spec": {"serviceDiscovery": "static", "routingLogic": "roundrobin",
                     "staticBackends": engines[1], "staticModels": model,
                     "routerRef": {"kind": "Service", "name": "router-svc"},
                     "healthCheck": {"successThreshold": 1}}}
        operator = start_controller("production_stack_tpu_torch.controller", api.url,
                                    log_dir)
        key = ("default", "route-a-dynamic-config")
        row["reconciled_s"] = wait_for(
            "the operator's ConfigMap and status",
            lambda: key in api.configmaps and api.status_of("staticroutes", "route-a"), 15)
        status = api.status_of("staticroutes", "route-a")
        cond = status["conditions"][0]
        owner = api.configmaps[key]["metadata"]["ownerReferences"][0]
        if cond["type"] != "HealthCheckSucceeded" or owner["uid"] != "uid-a" or \
                status["configMapRef"] != key[1]:
            fail(f"router operator: status {status}, owner {owner}")
        tmp = cfg + ".tmp"
        with open(tmp, "w") as f:
            f.write(api.configmaps[key]["data"]["dynamic_config.json"])
        os.replace(tmp, cfg)

        def backends():
            return [b["url"] for b in json.loads(request("GET", router.url + "/fleet")[2])[
                "backends"]]

        row["repointed_s"] = wait_for("the router's re-pointing",
                                      lambda: backends() == [engines[1]], 10)
        st, evs, *_ = sse_request(router.url + "/v1/chat/completions", {
            "model": model, "temperature": 0, "max_tokens": 4, "ignore_eos": True,
            "stream": True, "messages": [{"role": "user", "content": "re-pointed"}]},
            {"x-request-id": "operator-routed"})
        if st != 200 or served_by(engines, "operator-routed") != engines[1]:
            fail(f"router operator: the chat after the ConfigMap answered {st}")
        row.update(condition=cond["type"], backends_after=1,
                   **router_off_card("operator", [router.proc.pid, operator.pid], pids))
    finally:
        if operator is not None:
            operator.terminate()
            operator.wait(30)
        router.stop()
        api.close()
    row["seconds"] = time.monotonic() - t_round
    log(f"router operator: {json.dumps(row)}")
    return row


def lora_controller_paths(root, adapters, log_dir):
    """The ckpt phase's adapters through the LoraAdapter controller (a
    process, against a fake API server): each a ``local`` CR copied into
    the shared directory; returns ({name: the path its status reports},
    summary row)."""
    t0 = time.monotonic()
    api = FakeKubeApi()
    for name, path in adapters.items():
        api.loraadapters[("default", name)] = {
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"baseModel": "llama-3b", "adapterSource": {
                "type": "local", "adapterName": f"adapter-{name}", "adapterPath": path}}}
    shared = os.path.join(root, "shared")
    proc = start_controller("production_stack_tpu_torch.controller.lora_main", api.url,
                            log_dir, "--adapters-dir", shared)
    try:
        def ready():
            return all((api.status_of("loraadapters", n) or {}).get("phase") == "Ready"
                       for n in adapters)

        wait_for("the LoraAdapter controller's Ready", ready, 30)
        off = router_off_card("lora controller", [proc.pid], [])
    finally:
        proc.terminate()
        proc.wait(30)
        api.close()
    phases = {n: [st["phase"] for k, m, st in api.patches if m == n] for n in adapters}
    paths = {n: api.status_of("loraadapters", n)["adapterPath"] for n in adapters}
    for n, path in paths.items():
        if phases[n] != ["Downloading", "Ready"] or \
                path != os.path.join(shared, f"adapter-{n}") or \
                sorted(os.listdir(path)) != sorted(os.listdir(adapters[n])):
            fail(f"ckpt: the LoraAdapter controller reported {phases[n]}, {path}")
    return paths, {"phases": phases, "seconds": time.monotonic() - t0,
                   "controller_nvidia_files": off["router_nvidia_files"]}


CHART_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "helm")
CHART_RELEASE = "smoke"
CHART_NAMESPACE = "default"
# The router phase's engines take these server flags beside the chart's:
# the chart has no key for them.
CHART_EXTRA_FLAGS = ("--seed", "--num-kv-blocks", "--max-num-batched-tokens")


def chart_values(model, engine_port=8000, router_port=8000):
    """The values the router phase renders ``helm/`` with: one modelSpec of
    ``model`` on one NVIDIA card, the chart's keys for every flag of
    ``kvtier_server_args("bfloat16", seed)`` it renders, and a session
    router (``x-user-id``, 1 s stats interval)."""
    return {
        "servingEngineSpec": {
            "containerPort": engine_port,
            "modelSpec": [{
                "name": "llama", "repository": "production-stack-tpu-torch/engine",
                "tag": "latest", "modelURL": model, "replicaCount": 2,
                "requestGPUType": "nvidia.com/gpu", "requestGPU": 1,
                "vllmConfig": {"dtype": "bfloat16", "maxModelLen": 4096, "maxNumSeqs": 4},
                "tpuConfig": {"attnImpl": "paged", "numDecodeSteps": 32,
                              "kvCacheDtype": "bfloat16",
                              "compilationCacheDir": ELASTIC_CACHE},
            }],
        },
        "routerSpec": {"containerPort": router_port, "routingLogic": "session",
                       "sessionKey": "x-user-id", "engineScrapeInterval": 1},
    }


def chart_render(values):
    """The port's ``helm_lite`` over ``helm/`` in this process: (engine
    Deployment, router Deployment, seconds)."""
    from production_stack_tpu_torch.helm_lite import render_chart

    t0 = time.monotonic()
    manifests = render_chart(CHART_DIR, values, release_name=CHART_RELEASE,
                             release_namespace=CHART_NAMESPACE)
    seconds = time.monotonic() - t0
    deployments = {m["metadata"]["name"]: m for m in manifests if m["kind"] == "Deployment"}
    engine = [d for n, d in deployments.items() if n.endswith("-deployment-engine")]
    router = deployments.get(f"{CHART_RELEASE}-deployment-router")
    if len(engine) != 1 or router is None:
        fail(f"router chart: rendered Deployments {sorted(deployments)}")
    return engine[0], router, seconds


def chart_args(deployment, container):
    c = next(c for c in deployment["spec"]["template"]["spec"]["containers"]
             if c["name"] == container)
    return [str(a) for a in c["args"]], c


def chart_engine_argv(model, seed, engine, port, device_type):
    """The rendered engine container's ``command`` + ``args`` as the router
    phase runs them: exactly as rendered but for ``--host`` / ``--port``
    (loopback, ``port``), with the smoke's flags the chart has no key for
    appended (and ``--device`` off the card)."""
    args, container = chart_args(engine, "engine")
    argv = [str(c) for c in container["command"]] + args
    for flag in ("--model", "--served-model-name"):
        if argv[argv.index(flag) + 1] != model:
            fail(f"router chart: {flag} rendered as {argv[argv.index(flag) + 1]!r}, "
                 f"not {model!r}")
    for flag, value in (("--host", "127.0.0.1"), ("--port", str(port))):
        argv[argv.index(flag) + 1] = value
    want = kvtier_server_args("bfloat16", seed)
    for flag in CHART_EXTRA_FLAGS:
        argv += want[want.index(flag):want.index(flag) + 2]
    if device_type != "cuda":
        argv += ["--device", device_type]
    return argv


def chart_check(model, seed, device_type):
    """Render the chart for the router phase's engines and hold it: PyYAML
    never loaded, the engine asks for one ``nvidia.com/gpu``, and its
    command's args parse to today's ``kvtier_server_args`` Namespace (with
    the rendered ``--served-model-name``, the model's own name). Returns
    (the engine Deployment, summary row)."""
    from production_stack_tpu_torch.server.api_server import parse_args

    engine, router, seconds = chart_render(chart_values(model))
    argv = chart_engine_argv(model, seed, engine, 0, device_type)
    _, container = chart_args(engine, "engine")
    res = container["resources"]
    gpus = [res.get("requests", {}).get("nvidia.com/gpu"),
            res.get("limits", {}).get("nvidia.com/gpu")]
    twin = ["--model", model, "--served-model-name", model, "--host", "127.0.0.1",
            "--port", "0"] + (["--device", device_type] if device_type != "cuda" else [])
    got = vars(parse_args(argv[1:]))
    want = vars(parse_args(twin + kvtier_server_args("bfloat16", seed)))
    diff = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
            if got.get(k) != want.get(k)}
    if "yaml" in sys.modules or gpus != ["1", "1"] or diff:
        fail(f"router chart: yaml loaded {'yaml' in sys.modules}, nvidia.com/gpu "
             f"{gpus}, Namespace differs from kvtier_server_args at {diff}")
    row = {"render_s": seconds, "engine_argv": argv, "nvidia_gpu": gpus,
           "namespace_equal": True, "yaml_loaded": False,
           "router_args": chart_args(router, "router")[0]}
    log(f"router chart: {json.dumps(row)}")
    return engine, row


def install_port(here, work):
    """Install this tree's port as the engine image
    (``docker/torch/Dockerfile.engine``) installs it, outside the checkout:
    ``pyproject.toml``, ``README.md`` and ``production_stack_tpu_torch/``
    copied to ``work/src`` (setuptools writes ``build/`` and
    ``*.egg-info`` beside its sources), one ``pip install --target`` with no
    dependencies into ``work/prefix``, and ``bin/pstpu-engine`` linked to
    ``bin/pstpu-torch-engine`` as the image links it. Returns (prefix,
    summary row)."""
    prefix = os.path.join(work, "prefix")
    src = os.path.join(work, "src")
    os.makedirs(src)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(here, name), src)
    shutil.copytree(os.path.join(here, "production_stack_tpu_torch"),
                    os.path.join(src, "production_stack_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    cmd = [sys.executable, "-m", "pip", "install", "--no-deps", "--no-build-isolation",
           # nothing is fetched, and pip checks for no newer pip
           "--no-index", "--target", prefix, src]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=work, capture_output=True, text=True,
                          env=dict(os.environ, PIP_DISABLE_PIP_VERSION_CHECK="1"))
    row = {"install_s": time.monotonic() - t0}
    log(f"router install: {' '.join(cmd)} -> {proc.returncode}\n"
        f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    if proc.returncode != 0:
        fail(f"router install: pip install exited {proc.returncode}: {proc.stderr[-500:]}")
    os.symlink("pstpu-torch-engine", os.path.join(prefix, "bin", "pstpu-engine.tmp"))
    os.replace(os.path.join(prefix, "bin", "pstpu-engine.tmp"),
               os.path.join(prefix, "bin", "pstpu-engine"))
    from production_stack_tpu_torch.ops import paged_attention as pa

    for name in map(os.path.basename, (pa.HEADER, *pa.SOURCES)):
        shipped = os.path.join(prefix, "production_stack_tpu_torch", "csrc", name)
        if not os.path.isfile(shipped):
            fail(f"router install: the install holds no {shipped}")
    row["prefix"] = prefix
    log(f"router install: {json.dumps(row)}")
    return prefix, row


def start_installed_engines(argv_of, prefix, work, log_dir, n=2, timeout_s=600):
    """Start ``n`` engines from the installed port: engine i runs
    ``argv_of(port_i)`` (the rendered command first, found on ``PATH``, led
    by the prefix's ``bin/``), with the prefix alone on ``PYTHONPATH``, its
    working directory ``work`` and ``XDG_CACHE_HOME`` a fresh, empty
    directory (both outside the checkout), so each builds the shipped
    kernel source cold; then wait for every ``/health``. Returns (the
    engines' ``launch.EngineHandle``, the kernel cache, the resolved
    command)."""
    from production_stack_tpu_torch.launch import EngineHandle, _healthy, free_port

    cache = os.path.join(work, "xdg-cache")
    os.makedirs(cache)
    env = dict(os.environ, PYTHONPATH=prefix, XDG_CACHE_HOME=cache,
               PATH=os.pathsep.join([os.path.join(prefix, "bin"), os.environ.get("PATH", "")]))
    resolved = shutil.which(argv_of(0)[0], path=env["PATH"])
    handle = EngineHandle([], [], [], [], [])
    t0 = time.monotonic()
    try:
        for _ in range(n):
            port = free_port()
            argv = argv_of(port)
            path = os.path.join(log_dir, f"engine-{port}.log")
            with open(path, "wb") as f:
                handle.procs.append(subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT,
                                                     env=env, cwd=work))
            handle.argvs.append(argv)
            handle.urls.append(f"http://127.0.0.1:{port}")
            handle.log_paths.append(path)
        for proc, url in zip(handle.procs, handle.urls):
            while not _healthy(url):
                if proc.poll() is not None or time.monotonic() - t0 > timeout_s:
                    fail(f"router: the installed engine {url} exited {proc.poll()} or "
                         f"was not healthy in {timeout_s} s; see {log_dir}")
                time.sleep(0.2)
            handle.ready_seconds.append(time.monotonic() - t0)
    except BaseException:
        handle.stop(timeout_s=10.0)
        raise
    return handle, cache, resolved


def installed_engine_check(procs, prefix, cache, here, docs, on_card=True):
    """Each engine process runs the prefix's script (``/proc/<pid>/cmdline``),
    imported the prefix's package (``package_dir`` of its
    ``/debug/kernels``: modules are read, not mapped, so no map shows it),
    and maps exactly one ``libpaged_decode-*.so``, from ``cache``'s kernel
    directory, and no file of the checkout (``/proc/<pid>/maps``); both
    engines' kernel libraries are the one file the cold build left there.
    ``docs``: each engine's ``/debug/kernels`` answer (its ``stats`` give the
    build's seconds). Off the card (``on_card`` false) no kernel is built
    and none is looked for. Returns the summary row."""
    kdir = os.path.join(cache, "production_stack_tpu_torch", "kernels")
    script = os.path.realpath(os.path.join(prefix, "bin", "pstpu-torch-engine"))
    package = os.path.realpath(os.path.join(prefix, "production_stack_tpu_torch"))
    row = {"kernel_dir": kdir, "kernel_dir_files": sorted(os.listdir(kdir))
           if os.path.isdir(kdir) else [], "engines": []}
    for proc, doc in zip(procs, docs):
        with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
            cmdline = [a.decode() for a in f.read().split(b"\0") if a]
        mapped = set()
        with open(f"/proc/{proc.pid}/maps") as f:
            for line in f:
                parts = line.split(None, 5)
                if len(parts) == 6 and parts[5].startswith("/"):
                    mapped.add(parts[5].strip())
        libs = sorted(p for p in mapped
                      if os.path.basename(p).startswith("libpaged_decode-"))
        ours = sorted(p for p in mapped if p.startswith(here + os.sep))
        eng = {"pid": proc.pid, "script": cmdline[1:2],
               "package_dir": doc.get("package_dir"), "kernel_libs": libs,
               "checkout_files_mapped": ours,
               "kernel_build_s": doc["stats"]["startup_phase_seconds"].get("kernel_build")}
        row["engines"].append(eng)
        if len(cmdline) < 2 or os.path.realpath(cmdline[1]) != script or ours or (
                os.path.realpath(eng["package_dir"] or "") != package) or (
                on_card and (len(libs) != 1 or os.path.dirname(libs[0]) != kdir)):
            fail(f"router: engine {proc.pid} is not the installed port: {json.dumps(eng)}")
    if on_card and len({e["kernel_libs"][0] for e in row["engines"]}) != 1:
        fail(f"router: the engines map different kernel libraries: {json.dumps(row)}")
    log(f"router installed engines: {json.dumps(row)}")
    return row


def router_chart_round(model, engines, pids, log_dir, n_layers, variant):
    """Round (h), the chart's router: the chart rendered again with the
    second engine's port (``--k8s-port``), a free router port and the
    namespace ``default``; ``python -m production_stack_tpu_torch.router.app``
    started with exactly the rendered router args, behind a fake in-cluster
    API server listing one ready pod on the second engine with the rendered
    pod template's labels. One greedy chat of ``FEATURE_TOKENS`` tokens
    through it equals its twin straight to the engine (both after a prime,
    so they find the same prefix-cache state); the engines' kernel counts
    over the round are layers x their decode steps, none eager; the router
    holds no ``/dev/nvidia*`` file. Returns (launches, summary row)."""
    from production_stack_tpu_torch.launch import _child_env, _healthy, free_port

    t_round = time.monotonic()
    target = engines[1]
    port = int(target.rsplit(":", 1)[1])
    rport = free_port()
    engine, router, render_s = chart_render(chart_values(model, port, rport))
    args, _ = chart_args(router, "router")
    labels = engine["spec"]["template"]["metadata"]["labels"]
    selector = args[args.index("--k8s-label-selector") + 1]
    if args[args.index("--k8s-port") + 1] != str(port) or \
            args[args.index("--k8s-namespace") + 1] != CHART_NAMESPACE or \
            any(labels.get(k) != v for k, v in (c.split("=", 1) for c in selector.split(","))):
        fail(f"router chart round: rendered router args {args}, pod labels {labels}")
    api = FakeKubeApi(tls=True)
    api.pods["engine-1"] = {"metadata": {"name": "engine-1", "labels": dict(labels)},
                            "status": {"podIP": "127.0.0.1",
                                       "containerStatuses": [{"ready": True}]}}
    env = dict(_child_env(), KUBERNETES_SERVICE_HOST="127.0.0.1",
               KUBERNETES_SERVICE_PORT=str(api.port))
    log_path = os.path.join(log_dir, f"chart-router-{rport}.log")
    proc = None
    row = {"render_s": render_s, "router_args": args}
    try:
        with open(log_path, "wb") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "production_stack_tpu_torch.router.app", *args],
                stdout=f, stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        url = f"http://127.0.0.1:{rport}"
        row["router_up_s"] = wait_for("the chart's router", lambda: proc.poll() is None
                                      and _healthy(url), 60)

        def models():
            return [m["id"] for m in json.loads(
                request("GET", url + "/v1/models")[2])["data"]]

        row["discovered_s"] = wait_for("k8s discovery of the chart's pod",
                                       lambda: models() == [model], 10)
        for u in engines:
            request("POST", u + "/debug/kernels/reset")
        before = {u: engine_kernels(u)["stats"] for u in engines}
        body = {"model": model, "temperature": 0, "max_tokens": FEATURE_TOKENS,
                "ignore_eos": True, "stream": True, "messages": [
                    {"role": "user", "content": feature_prompt("chart", 0)}]}
        prime([target], body)
        st, evs, *_ = sse_request(url + "/v1/chat/completions", body,
                                  {"x-request-id": "chart-routed", "x-user-id": "chart"})
        where = served_by(engines, "chart-routed")
        st_d, evs_d, *_ = sse_request(target + "/v1/chat/completions", body,
                                      {"x-pstpu-resume": "1", "x-request-id": "chart-twin"})
        toks, toks_d = event_tokens(evs), event_tokens(evs_d)
        if where != target or (st, st_d) != (200, 200) or len(toks) != FEATURE_TOKENS \
                or toks != toks_d:
            fail(f"router chart round: served by {where} (want {target}), HTTP "
                 f"{st}/{st_d}, tokens equal {toks == toks_d}")
        launches = []
        for u in engines:
            k = engine_kernels(u)
            steps = k["stats"]["decode_steps_total"] - before[u]["decode_steps_total"]
            eager = (k["stats"]["decode_eager_dispatches_total"]
                     - before[u]["decode_eager_dispatches_total"])
            launches.append(k["launch_counts"].get(variant, 0))
            if launches[-1] != n_layers * steps or eager or (u == target and not steps):
                fail(f"router chart round: {u} launched {k['launch_counts']} for {steps} "
                     f"decode steps ({n_layers} layers), {eager} eager dispatches")
        sent = api.lists[0].get("labelSelector") if api.lists else None
        if sent != selector:
            fail(f"router chart round: the router listed pods with {sent!r}, the chart "
                 f"rendered {selector!r}")
        row.update(tokens_equal_twin=True, launches=launches, label_selector=sent,
                   pod_labels=labels, **router_off_card("chart", [proc.pid], pids))
    finally:
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        api.close()
    row["seconds"] = time.monotonic() - t_round
    log(f"router chart round: {json.dumps(row)}")
    return sum(launches), row


def router_phase(torch, pa, device, seed, card, model, disagg_rows):
    """Phase 15 (see the module docstring). ``disagg_rows``: round (c)'s
    rows from the kvtier phase. Returns (launches, summary)."""
    from production_stack_tpu_torch.launch import launch_router
    from production_stack_tpu_torch.models.config import resolve_model_config

    faulthandler.dump_traceback_later(ROUTER_WATCHDOG_S, exit=True)
    log_dir = os.path.join(os.path.dirname(DETAIL_LOG), "router")
    os.makedirs(log_dir, exist_ok=True)
    n_layers = resolve_model_config(model).num_layers
    here = os.path.dirname(os.path.abspath(__file__))
    # The chart, rendered here by the port's helm_lite: its engine
    # container's command and args start the phase's two engines, from the
    # port installed outside the checkout.
    engine_dep, chart = chart_check(model, seed, device.type)
    out = {"card": card, "chart": chart}
    rounds = out["round_s"] = {}
    work = tempfile.mkdtemp(prefix="pstpu-smoke-install-")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    if os.path.realpath(work).startswith(here + os.sep):
        fail(f"router: the temporary directory {work} lies inside the checkout")
    handle, session, cache_router = None, None, None
    launches = 0
    try:
        prefix, out["install"] = install_port(here, work)
        t_up = time.monotonic()
        handle, cache, resolved = start_installed_engines(
            lambda port: chart_engine_argv(model, seed, engine_dep, port, device.type),
            prefix, work, log_dir)
        engines, pids = handle.urls, [p.pid for p in handle.procs]
        out["engine_ready_s"] = handle.ready_seconds
        out["install"]["command"] = resolved
        out["install"].update(installed_engine_check(
            handle.procs, prefix, cache, here,
            [engine_kernels(u) for u in engines], on_card=device.type == "cuda"))
        session = launch_router(engines, [model], [
            "--routing-logic", "session", "--session-key", "x-user-id",
            "--engine-stats-interval", "1"], log_dir)
        session_url, session_pid = session.url, session.proc.pid
        out["up_s"] = time.monotonic() - t_up
        # (a) session
        t0 = time.monotonic()
        with SmMhz() as clock:
            n, out["session"], where_of = router_chat_round(
                "session", session_url, engines, model, n_layers, pa.BF16)
        out["session"]["sm_clock_mhz"] = clock.summary()
        launches += n
        out["session"]["families"] = router_metrics_check("session", session_url, engines)
        out["session"].update(router_off_card("session", [session_pid], pids))
        rounds["a"] = time.monotonic() - t0
        # (b) cache-aware, a second router on the same engines
        t0 = time.monotonic()
        cache_router = launch_router(engines, [model], [
            "--routing-logic", "cache_aware_load_balancing", "--session-key", "x-user-id",
            "--engine-stats-interval", "1"], log_dir)
        out["cache_aware_router_up_s"] = time.monotonic() - t0
        with SmMhz() as clock:
            n, out["cache_aware"], _ = router_chat_round(
                "cache-aware", cache_router.url, engines, model, n_layers, pa.BF16)
        out["cache_aware"]["sm_clock_mhz"] = clock.summary()
        launches += n
        out["cache_aware"]["families"] = router_metrics_check(
            "cache-aware", cache_router.url, engines)
        out["cache_aware"].update(router_off_card(
            "cache-aware", [cache_router.proc.pid], pids))
        cache_router.stop()
        cache_router = None
        rounds["b"] = time.monotonic() - t0
        # (e) the gated router, (f) Kubernetes discovery, (g) the operator:
        # the engines' bf16 launches over the three are part of the path.
        # (e)'s batch lines, whole, on both engines first: the prefix-cache
        # state each line and its twins then share, and the first use of
        # the logprobs decode variant (its capture runs every layer's
        # kernel once) before the path's counts are set to 0.
        t0 = time.monotonic()
        bodies = feature_batch_bodies(model)
        for b in bodies:
            prime(engines, b, whole=True)
        for url in engines:
            request("POST", url + "/debug/kernels/reset")
        before = {url: engine_kernels(url)["stats"] for url in engines}
        out["gated"] = router_gated_round(model, engines, pids, log_dir, bodies)
        out["k8s"] = router_k8s_round(model, engines, pids, log_dir)
        out["operator"] = router_operator_round(model, engines, pids, log_dir)
        out["features_s"] = rounds["e-g"] = time.monotonic() - t0
        feature_launches = []
        for url in engines:
            k = engine_kernels(url)
            steps = k["stats"]["decode_steps_total"] - before[url]["decode_steps_total"]
            eager = (k["stats"]["decode_eager_dispatches_total"]
                     - before[url]["decode_eager_dispatches_total"])
            feature_launches.append(k["launch_counts"].get(pa.BF16, 0))
            if feature_launches[-1] != n_layers * steps or not steps or eager:
                fail(f"router (e)-(g): {url} launched {k['launch_counts']} for {steps} "
                     f"decode steps ({n_layers} layers), {eager} eager dispatches")
        out["features_launches"] = feature_launches
        launches += sum(feature_launches)
        # (h) the chart's router, Kubernetes-discovered
        n, out["chart_router"] = router_chart_round(model, engines, pids, log_dir,
                                                    n_layers, pa.BF16)
        rounds["h"] = out["chart_router"]["seconds"]
        launches += n
        # (d) failover, last: it kills an engine
        t0 = time.monotonic()
        k, out["failover"] = router_failover(
            "session", session_url, session.log_path, engines, pids, model, where_of,
            "failover")
        launches += k["launch_counts"].get(pa.BF16, 0)
        if k["launch_counts"].get(pa.BF16, 0) != n_layers * out["failover"]["survivor_decode_steps"]:
            fail(f"router failover: the survivor launched {k['launch_counts']} for "
                 f"{out['failover']['survivor_decode_steps']} decode steps")
        out["failover"].update(router_off_card("failover", [session_pid], pids))
        rounds["d"] = time.monotonic() - t0
    finally:
        t0 = time.monotonic()
        for r in (cache_router, session, handle):
            if r is not None:
                r.stop()
        rounds["drain"] = time.monotonic() - t0
        shutil.rmtree(work, ignore_errors=True)
        faulthandler.cancel_dump_traceback_later()
    out["disagg"] = disagg_rows
    log(f"router result {json.dumps(out)}")
    return launches, out


def main() -> None:
    t_main = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="kernel,serving,graphs,elastic,check,domain,tp,sp,"
                            "surface,kvtier,kvtier-tp,kvtier-native,spec,ckpt,"
                            "opt-tp,spec-dp,router",
                    help="comma list of kernel,serving,graphs,elastic,check,"
                         "domain,tp,sp,surface,kvtier,kvtier-tp,kvtier-native,"
                         "spec,ckpt,opt-tp,spec-dp,router,trace (build always "
                         "runs; trace profiles one more served round after "
                         "serving; router runs kvtier too, whose pair its "
                         "disagg round drives)")
    ap.add_argument("--tp-kernel-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # a rank of the tp phase's kernel check
    ap.add_argument("--tp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--tp-lens", default="", help=argparse.SUPPRESS)
    # the kvtier phase's second engine process
    ap.add_argument("--kvtier-peer", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--kv-url", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--kvtier-model", default="llama-3b", help=argparse.SUPPRESS)
    ap.add_argument("--kvtier-device", default="cuda", help=argparse.SUPPRESS)
    # the kvtier-tp phase's second process (its round 4)
    ap.add_argument("--kvtier-tp-peer", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--disagg-repeats", type=int, default=0,
                    help="send round (c)'s chats this many more times through its "
                         "router, each held to the hand-driven hops' tokens")
    args = ap.parse_args()
    global DISAGG_REPEATS
    DISAGG_REPEATS = args.disagg_repeats
    phases = set(args.phases.split(","))
    if "router" in phases:
        phases.add("kvtier")
    if (args.kvtier_peer, args.kvtier_tp_peer, args.tp_kernel_rank) != (None,) * 3:
        # A helper process keeps its own detail log: opening the run's
        # would truncate it under the parent's writes.
        global DETAIL_LOG
        DETAIL_LOG = DETAIL_LOG[:-len(".log")] + f".{os.getpid()}.log"
    if args.kvtier_peer is not None:
        kvtier_peer_main(args.seed, args.kvtier_peer, args.kv_url,
                         args.kvtier_model, args.kvtier_device)
        return
    if args.kvtier_tp_peer is not None:
        kvtier_tp_peer_main(args.seed, args.kvtier_tp_peer, args.kv_url,
                            args.kvtier_model, args.kvtier_device)
        return
    if args.tp_kernel_rank is not None:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        tp_kernel_rank_main(args.seed, args.tp_kernel_rank, args.tp_port,
                            args.tp_device, [int(n) for n in args.tp_lens.split(",")])
        return

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs "
              "one NVIDIA GPU", flush=True)
        sys.exit(2)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "production_stack_tpu_torch")):
        print("FAIL: the port package production_stack_tpu_torch/ is not "
              "beside this script (run it from a checkout)", flush=True)
        sys.exit(3)
    sys.path.insert(0, here)
    # Every run's first start of a configuration is cold.
    shutil.rmtree(ELASTIC_CACHE, ignore_errors=True)
    from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
    from production_stack_tpu_torch.ops import paged_attention as pa
    # Full-precision f32 products in every plain reference below.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    print(f"card: {card}", flush=True)
    with SmMhz() as idle:
        time.sleep(1.0)
    summary("card", {"nvidia_smi": card, "torch": torch.__version__,
                     "cuda": torch.version.cuda,
                     "device": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count(),
                     "sm_clock_idle_mhz": idle.summary()})

    # 2. build
    t0 = time.monotonic()
    lib_path, ptxas = pa.build_kernels()
    build_s = time.monotonic() - t0
    insts = kernel_instances(pa, ptxas)
    for inst in insts:
        log(f"build: {json.dumps(inst)}")
    summary("build", {"seconds": build_s, "instances": [
        [i["variant"], i["Dh"], i["KG"], i["registers"], i.get("spill_stores", 0),
         i.get("spill_loads", 0), i["static_smem"], i["dynamic_smem"],
         i["blocks_per_sm"], i.get("pool") == 2] for i in insts],
        "instance_fields": ["variant", "Dh", "KG", "registers", "spill_stores",
                            "spill_loads", "static_smem", "dynamic_smem",
                            "blocks_per_sm", "one_token_pages"]})

    tok = ByteTokenizer(128256)
    prompts = make_prompts(args.seed, 4)
    # Served rows mid-decode: chat prompts carry the template's bytes.
    main_lens = [len(tok.encode(p)) + 32 for p in prompts]
    # Serving runs before the kernel phase: the kernel phase's profiler
    # must not perturb the serving numbers. Each serving run is one main
    # path: its launch counts are set to 0 before it and read after it.
    # launches by main path: each path's counts are set to 0 just before
    # it and read just after it.
    by_path = {"bf16": {}, "int8": {}, **{name: {} for name in pa.VARIANTS[2:]}}
    # (phase, its start): the summary's seconds per phase.
    marks = [("build", t_main)]
    # The depth-cut checkpoint directories (``CUT_LAYERS``), removed at exit
    # (``fail`` too).
    cut_dirs = {}
    atexit.register(lambda: [shutil.rmtree(d, ignore_errors=True)
                             for d in cut_dirs.values()])
    # Serving, then the graphs phase on the serving engine (still warm),
    # per KV dtype: one engine's graphs are captured once for both. Both
    # run llama-3b cut to ``CUT_LAYERS``.
    # The elastic phase follows the bf16 graphs: its cold start (a) is the
    # serving phase's engine (its rounds run before the graphs phase takes
    # it), its verified start (b) boots once (a) is gone.
    marks.append(("serving+graphs", time.monotonic()))
    phase_s = {"serving": 0.0, "graphs": 0.0, "elastic": 0.0}
    serving_rows, rows, pre, elastic = {}, [], {}, None
    for kv in ("bfloat16", "int8"):
        variant = "int8" if kv == "int8" else "bf16"
        engine = None
        cold = None
        t0 = time.monotonic()
        with_elastic = "elastic" in phases and kv == "bfloat16"
        model = "llama-3b"
        if phases & {"serving", "graphs", "elastic"}:
            model = cut_model(torch, device, args.seed, "llama-3b", cut_dirs)
        if "serving" in phases:
            counts, serving_rows[kv], engine = serving_phase(
                torch, pa, device, args.seed, prompts, card, kv,
                trace="trace" in phases and kv == "bfloat16",
                keep="graphs" in phases or with_elastic, model=model)
            by_path[variant]["serving"] = counts[pa.INT8 if variant == "int8" else pa.BF16]
        t1 = time.monotonic()
        if with_elastic and engine is not None:
            cold = elastic_rounds(torch, pa, engine, prompts, "cold")
        t2 = time.monotonic()
        if "graphs" in phases:
            runs, pre[kv] = graphs_phase(torch, pa, device, args.seed, card, kv,
                                         engine=engine, model=model)
            rows += runs
        elif engine is not None:
            engine.shutdown()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        t3 = time.monotonic()
        if with_elastic:
            by_path["bf16"]["elastic"], elastic = elastic_phase(
                torch, pa, device, args.seed, card, prompts, cold, model=model)
        phase_s["serving"] += t1 - t0
        phase_s["graphs"] += t3 - t2
        phase_s["elastic"] += t2 - t1 + time.monotonic() - t3
    if serving_rows:
        summary("serving", {kv: {k: r[k] for k in (
            "kv_blocks", "wall_s", "ttft_s_streamed", "decode_ms_per_step_events",
            "aggregate_tok_s", "dispatch_overlap_ratio", "peak_mem_gib", "decode_steps",
            "launches", "graphs", "sm_clock_mhz", "startup")}
            for kv, r in serving_rows.items()})
    if elastic is not None:
        summary("elastic", elastic)
    if "graphs" in phases:
        summary("prefill", {kv: {k: r[k] for k in (
            "kv_num_blocks", "kv_blocks_without_prefill_graphs", "prefill_reserve_bytes",
            "prefill_graph_families", "prefill_graph_nodes_max", "prefill_warm_seconds",
            "prefill_capture_seconds", "graph_pool_bytes", "graph_pool_bytes_prefill",
            "graph_capture_seconds", "startup_warmup_seconds", "ttft_s_short",
            "ttft_s_long", "landing_gap_s", "landing_prefill_host_s", "padding",
            "peak_mem_gib", "exact_rows")} for kv, r in pre.items()})
        t0 = time.monotonic()
        window = graphs_window_check(torch, args.seed)
        phase_s["graphs"] += time.monotonic() - t0
        summary("graphs", {"runs": [
            [r["kv_cache_dtype"], r["run"], r["mode"], r["decode_ms_per_step_events"],
             r["decode_ms_per_step_wall"], sum(r["ttft_s"]) / len(r["ttft_s"]),
             r["aggregate_tok_s"], r["peak_mem_gib"], r["decode_eager_dispatches"],
             r["step_bound_ms"],
             r["sm_clock_mhz"]["mean"] if isinstance(r["sm_clock_mhz"], dict) else None,
             r["prefill_eager_dispatches"], r["prefill_graph_dispatches"]]
            for r in rows],
            "run_fields": ["kv", "run", "mode", "ms_per_step_events", "ms_per_step_wall",
                           "ttft_s_mean", "tok_s", "peak_gib", "eager_dispatches",
                           "step_bound_ms", "sm_clock_mhz_mean",
                           "prefill_eager_dispatches", "prefill_graph_dispatches"],
            "warmup": [{k: r[k] for k in (
                "kv_cache_dtype", "run", "warmup_s", "graph_families", "graphs_captured",
                "graph_capture_seconds", "graph_pool_bytes", "graph_families_logprobs",
                "graph_pool_bytes_logprobs", "prefill_graph_families",
                "prefill_warm_seconds", "prefill_capture_seconds",
                "graph_pool_bytes_prefill", "kv_blocks")}
                for r in rows if r["mode"] == "graph"],
            "overlap_round": [r["overlap_round"] for r in rows if r.get("overlap_round")],
            "tokens_graph_equal_eager": True, **window})
    marks.append(("check", time.monotonic()))
    if "check" in phases:
        summary("check", {"bf16": check_phase(torch, device, args.seed, False),
                          "int8": check_phase(torch, device, args.seed, True),
                          "gumbel_values_differing": check_noise(torch, device)})
    # The domain phase: the generic kernel's variants on their main paths
    # (llama-3b in float32, tiny-llama in bf16 and float16, each over
    # compute-dtype and int8 pools), each served run's launches.
    marks.append(("domain", time.monotonic()))
    if "domain" in phases:
        launched, dom = domain_phase(torch, pa, device, args.seed, cut_dirs)
        for variant, n in launched.items():
            by_path[{pa.BF16: "bf16", pa.INT8: "int8"}.get(variant, variant)]["domain"] = n
        summary("domain", dom)
        gc.collect()
        torch.cuda.empty_cache()
    # The tp phase: llama-3-8b (cut) at tp = 2 on this card, bf16 then int8 KV;
    # each run is one main path of paged_flash_decode_stats_tp (its launch
    # counts, summed over the ranks, set to 0 before it and read after it).
    tp_launches, tp_rows = None, {}
    marks.append(("tp", time.monotonic()))
    if "tp" in phases:
        tp = {}
        tp_launches = 0
        model = cut_model(torch, device, args.seed, TP_MODEL, cut_dirs)
        for kv in ("bfloat16", "int8"):
            n, tp[kv] = tp_phase(torch, pa, device, args.seed, card, kv, model=model)
            tp_launches += n
        gc.collect()
        torch.cuda.empty_cache()
        tp_rows = tp_kernel_phase(torch, pa, device, args.seed, main_lens, card)
        summary("tp", {
            **{kv: {k: r[k] for k in (
                "backend", "engine_up_s", "decode_steps", "launches_per_rank",
                "ttft_s_streamed", "aggregate_tok_s", "decode_ms_per_step_tp1_eager",
                "decode_ms_per_step_tp2_eager", "peak_gib_per_rank", "peak_gib_tp1",
                "sm_clock_mhz")}
               | {"collective_share": r["profile_one_step"]["collective_share"],
                  "max_abs_logit_diff": r["logits"]["max_abs_logit_diff"],
                  "bound": r["logits"]["bound"]} for kv, r in tp.items()},
            "kernel": {v: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms", "max_abs_err")}
                       for v, r in tp_rows.items()}})
    # The sp phase: sp = 2, dp x sp x tp and the replication fallback, cut
    # to CUT_LAYERS; its tp = 1 ranks' runs are main paths of the
    # bf16 variant, its tp = 2 ranks' of paged_flash_decode_stats_tp (each
    # rank's launches, summed).
    sp_launches = None
    marks.append(("sp", time.monotonic()))
    if "sp" in phases:
        sp_summary, n_plain, sp_launches = sp_phase(torch, pa, device, args.seed,
                                                    card, cut_dirs)
        by_path["bf16"]["sp"] = n_plain
        summary("sp", sp_summary)
        gc.collect()
        torch.cuda.empty_cache()
    marks.append(("surface", time.monotonic()))
    if "surface" in phases:
        n, surface = surface_phase(
            torch, pa, device, args.seed, card,
            model=cut_model(torch, device, args.seed, "llama-3b", cut_dirs))
        by_path["bf16"]["surface"] = n
        summary("surface", surface)
        gc.collect()
        torch.cuda.empty_cache()
    # The KV tier: one cache server for both KV dtypes (their keys live in
    # separate namespaces); each dtype's run is one main path.
    marks.append(("kvtier", time.monotonic()))
    router_disagg = {}
    if "kvtier" in phases:
        from production_stack_tpu_torch.launch import launch_kv_server

        model = cut_model(torch, device, args.seed, "llama-3b", cut_dirs)
        # The Python server: the phase needs its 'H', 'I' and 'D' ops.
        kv_server = launch_kv_server(max_bytes=16 << 30,
                                     log_dir=os.path.dirname(DETAIL_LOG),
                                     force_python=True)
        try:
            kvt = {}
            for kv in ("bfloat16", "int8"):
                n, kvt[kv] = kvtier_phase(torch, pa, device, args.seed, card, kv,
                                          kv_server.url, model=model,
                                          router="router" in phases and kv == "bfloat16")
                by_path["int8" if kv == "int8" else "bf16"]["kvtier"] = n
                if "router_disagg" in kvt[kv]:
                    n, router_disagg[kv] = kvt[kv].pop("router_disagg")
                    by_path["int8" if kv == "int8" else "bf16"]["router"] = n
        finally:
            kv_server.stop()
        summary("kvtier", {kv: {
            "ttft_s": r["ttft_s"], "link": {k: v for k, v in r["link"].items()
                                            if k.endswith(("gbps", "ms", "bytes", "clock_mhz"))},
            "restored_tokens": {k: r["rounds"][k]["restored_tokens"] for k in (
                "host-pool restore", "remote")},
            "restore": {k: {f: r["rounds"][k][f] for f in (
                "restore_s", "restores", "restore_write_s", "restore_write_bytes")}
                for k in ("host-pool restore", "remote")},
            "prewarm": r["prewarm"], "spill": r["spill"],
            "disagg": {k: r["disagg"][k] for k in (
                "ttft_s", "hop1_s", "handoff_bytes_per_request",
                "handoff_publish_s_per_request", "handoff_fetch_s_per_request",
                "decode_steps", "decode_launches")},
            "decode_ms_per_step_events": {k: v["decode_ms_per_step_events"]
                                          for k, v in r["rounds"].items()},
            "sm_clock_mhz": {k: v["sm_clock_mhz"]["mean"]
                             if isinstance(v["sm_clock_mhz"], dict) else None
                             for k, v in r["rounds"].items()},
            "engine_up_s": r["engine_up_s"], "spill_wait_s": r["spill_wait_s"],
            "blocks_spilled": r["blocks_spilled"], "peak_mem_gib": r["peak_mem_gib"],
            "stats": r["stats"]} for kv, r in kvt.items()})
        gc.collect()
        torch.cuda.empty_cache()
    # The KV tier at tp = 2 (llama-3-8b, both ranks on this card), per KV
    # dtype: its tp = 2 rounds are main paths of paged_flash_decode_stats_tp
    # (each rank's launches, summed), its tp = 1 cross-mesh rounds main
    # paths of the run's variant.
    kvtp_launches = None
    marks.append(("kvtier-tp", time.monotonic()))
    if "kvtier-tp" in phases:
        from production_stack_tpu_torch.launch import launch_kv_server

        model = cut_model(torch, device, args.seed, TP_MODEL, cut_dirs)
        kv_server = launch_kv_server(max_bytes=16 << 30,
                                     log_dir=os.path.dirname(DETAIL_LOG),
                                     force_python=True)
        try:
            kvtp = {}
            kvtp_launches = 0
            for kv in ("bfloat16", "int8"):
                n2, n1, kvtp[kv] = kvtier_tp_phase(torch, pa, device, args.seed, card,
                                                   kv, kv_server.url, model=model)
                kvtp_launches += n2
                by_path["int8" if kv == "int8" else "bf16"]["kvtier-tp"] = n1
        finally:
            kv_server.stop()
        summary("kvtier-tp", {kv: {
            "ttft_s": r["ttft_s"],
            "link_tp2": {k: v for k, v in r["link_tp2"].items()
                         if k.endswith(("gbps", "ms", "bytes", "_s"))},
            "link_tp1": {k: v for k, v in r["link_tp1"].items()
                         if k.endswith(("gbps", "ms", "bytes"))},
            "restored_tokens": {k: v["restored_tokens"] for k, v in r["rounds"].items()},
            "restore_s": {k: v["restore_s"] for k, v in r["rounds"].items()},
            "forced": {"tp2": r["forced_tp2"], "tp1": r["forced_tp1"]},
            "cross_tp1_forced": r["cross_tp1_forced"],
            "first_divergence": {"tp1 served": r["cross_tp1_served"]["first_divergence"],
                                 "pair": r["pair"]["bar"]["first_divergence"]},
            "pair": {k: r["pair"][k] for k in (
                "ttft_s", "hop1_s", "decode_steps", "decode_launches",
                "handoff_bytes_per_request", "handoff_publish_s_per_request",
                "prefill_restored_tokens")},
            "launches_tp2_ranks": r["launches_tp2_ranks"], "launches_tp1": r["launches_tp1"],
            "engine_up_s": [r["engine_up_s"], r["engine_up_s_peer"], r["engine_up_s_tp1"],
                            r["pair_up_s"]],
            "spill_wait_s": r["spill_wait_s"], "blocks_spilled": r["blocks_spilled"],
            "peak_gib_per_rank": r["peak_gib_per_rank"], "stats_tp2": r["stats_tp2"],
            "sm_clock_mhz": {k: v["sm_clock_mhz"]["mean"]
                             if isinstance(v["sm_clock_mhz"], dict) else None
                             for k, v in r["rounds"].items()}} for kv, r in kvtp.items()})
        gc.collect()
        torch.cuda.empty_cache()
    # The native cache-server core against the Python server: each
    # server's rounds are main paths of the bf16 kernel variant.
    marks.append(("kvtier-native", time.monotonic()))
    if "kvtier-native" in phases:
        n, native = kvtier_native_phase(
            torch, pa, device, args.seed, card,
            model=cut_model(torch, device, args.seed, "llama-3b", cut_dirs))
        by_path["bf16"]["kvtier-native"] = n
        summary("kvtier-native", native)
        gc.collect()
        torch.cuda.empty_cache()
    # Speculative decoding: both pairs, four modes each; the spec-off
    # rounds are main paths of the bf16 kernel variant.
    marks.append(("spec", time.monotonic()))
    if "spec" in phases:
        pairs = [(pair, cut_model(torch, device, args.seed, target, cut_dirs),
                  cut_model(torch, device, args.seed, draft, cut_dirs))
                 for pair, target, draft in SPEC_PAIRS]
        n, spec = spec_phase(torch, pa, device, args.seed, card, pairs=pairs)
        by_path["bf16"]["spec"] = n
        t0 = time.monotonic()
        n32, spec["f32_identity"] = spec_f32_identity(torch, pa, device, args.seed)
        by_path[pa.GENERIC[(torch.float32, False)]]["spec f32 identity"] = n32
        f32_s = time.monotonic() - t0
        keys = ("ms_per_dispatch_events", "ms_per_row_token_events",
                "ms_per_token_events", "aggregate_tok_s", "ttft_s", "acceptance", "draft_depth_mean",
                "tokens_per_target_step", "cycles_run", "cycles_live",
                "gamma0_dispatches", "graph_families", "graphs_captured",
                "graph_pool_bytes", "graph_capture_seconds", "peak_mem_gib",
                "first_divergence", "decode_dispatches", "decode_tokens",
                "ingest_buckets", "ingest_capture_seconds")
        summary("spec", {
            "card": card, "n": SPEC_N, "tokens": SPEC_TOKENS,
            "fields": list(keys),
            "pairs": {pair: {mode: [r.get(k) for k in keys]
                             for mode, r in v["modes"].items()}
                      for pair, v in spec["pairs"].items()},
            "sm_clock_mhz": {f"{pair} {mode}": (
                r["sm_clock_mhz"]["mean"] if isinstance(r["sm_clock_mhz"], dict)
                else None) for pair, v in spec["pairs"].items()
                for mode, r in v["modes"].items()},
            "f32_identity": spec["f32_identity"],
            # Where the phase's time goes: wall seconds per step of each
            # engine (up: build and warm-up; served; eager_logits;
            # graph_vs_eager; trace; down), then the float32 identity.
            "step_seconds": {f"{pair} {mode}": r["step_s"]
                             for pair, v in spec["pairs"].items()
                             for mode, r in v["modes"].items()},
            "f32_identity_seconds": f32_s,
            "trace": {f"{pair} {mode}": {k: r["trace"][k] for k in (
                "wall_s", "device_busy_s", "busy_share", "ms_by_class")}
                for pair, v in spec["pairs"].items()
                for mode, r in v["modes"].items() if "trace" in r},
            # The catch-up (the self pair's linear engine): host ms per
            # catch-up by bucket, replayed and in the strict eager twin.
            "ingest": {f"{pair} {mode}": r["ingest"]
                       for pair, v in spec["pairs"].items()
                       for mode, r in v["modes"].items() if "ingest" in r},
            "graph_equal_eager": True, "metrics_equal_stats": True})
        gc.collect()
        torch.cuda.empty_cache()
    # HF checkpoint directory and LoRA adapters: every served round is a
    # main path of the bf16 kernel variant.
    marks.append(("ckpt", time.monotonic()))
    if "ckpt" in phases:
        n, ck = ckpt_phase(torch, pa, device, args.seed, card,
                           model=cut_model(torch, device, args.seed, "llama-3b",
                                           cut_dirs))
        by_path["bf16"]["ckpt"] = n
        by_path[ck["merged_f32"]["variant"]]["ckpt merged f32"] = \
            ck["merged_f32"]["launches"]
        summary("ckpt", ck)
        gc.collect()
        torch.cuda.empty_cache()
    rows = []
    # The OPT family at tp = 2 (window path: no paged-kernel launch), then
    # speculative decoding at dp = 2, whose spec-off control round is a
    # main path of the bf16 kernel on each replica (their launches summed).
    marks.append(("opt-tp", time.monotonic()))
    if "opt-tp" in phases:
        summary("opt-tp", opt_tp_phase(torch, device, args.seed, card))
        gc.collect()
        torch.cuda.empty_cache()
    marks.append(("spec-dp", time.monotonic()))
    if "spec-dp" in phases:
        n, spec_dp = spec_dp_phase(torch, pa, device, args.seed, card, cut_dirs)
        by_path["bf16"]["spec-dp"] = n
        summary("spec-dp", spec_dp)
        gc.collect()
        torch.cuda.empty_cache()
    # The port's router in front of port engines: rounds (a) session, (b)
    # cache-aware and (d) failover here, (c) disagg in the kvtier phase;
    # the engines' bf16 launches of (a), (b), (d) and (c) are the path.
    marks.append(("router", time.monotonic()))
    if "router" in phases:
        n, rt = router_phase(torch, pa, device, args.seed, card,
                             cut_model(torch, device, args.seed, "llama-3b", cut_dirs),
                             router_disagg)
        by_path["bf16"]["router"] = by_path["bf16"].get("router", 0) + n
        summary("router", rt)
        gc.collect()
        torch.cuda.empty_cache()
    marks.append(("kernel", time.monotonic()))
    if "kernel" in phases:
        graph_check(torch, pa, device, args.seed, main_lens)
        rows = kernel_phase(torch, pa, device, args.seed, main_lens)
        summary("kernel", {"cases": [
            [r["case"], r["variant"], r["ms"], r["share_of_bound"], r["plain_ms"],
             r["library_ms"], r["vs_library"], r["max_abs_err"],
             r["sm_clock_mhz"]["mean"] if isinstance(r["sm_clock_mhz"], dict) else None]
            for r in rows],
            "case_fields": ["case", "variant", "ms", "share_of_bound", "plain_ms",
                            "library_ms", "vs_library", "max_abs_err",
                            "sm_clock_mhz_mean"],
            "main_path_events": {f"{r['case']} [{r['variant']}]": {k: r.get(k) for k in (
                "ms_events", "paged_attention_decode_ms",
                "paged_attention_ms")} for r in rows
                if r["case"].startswith("main path")},
            "timed_by": {f"{r['case']} {r['variant']}": [r["ms_by"], r["library_by"]]
                         for r in rows}})

    kernels = []
    for variant, name in (("bf16", pa.BF16), ("int8", pa.INT8),
                          *((n, n) for n in pa.VARIANTS[2:])):
        mine = [r for r in rows if r["kernel"] == name]
        # The main path's case; a variant on no main path (the generic
        # kernel's bf16 and f16 at head dim 16) its first case.
        main_row = next((r for r in mine if r["case"].startswith("main path")),
                        mine[0] if mine else {})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES["int8" if variant == "int8"
                                        or name.endswith("/int8]") else "bf16"],
            "launches": sum(by_path[variant].values()),
            "launches_by_path": by_path[variant],
            "max_abs_err": max((r["max_abs_err"] for r in mine), default=None),
            **{key: main_row.get(key) for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    # The tp op's numbers at a rank's shape (H 16, Hkv 4), bf16 pools; its
    # launches over both ranks of the tp phase's runs, every rank of the sp
    # phase's dp x sp x tp run and the kvtier-tp phase's tp = 2 rounds.
    tp_row = tp_rows.get("bf16", {})
    tp_paths = {k: v for k, v in (("tp", tp_launches), ("sp", sp_launches),
                                  ("kvtier-tp", kvtp_launches))
                if v is not None}
    kernels.append({
        "name": "paged_flash_decode_stats_tp",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": TP_KERNEL_REPLACES,
        "launches": sum(tp_paths.values()) if tp_paths else None,
        "launches_by_path": tp_paths,
        "max_abs_err": max((r["max_abs_err"] for r in tp_rows.values()), default=None),
        **{key: tp_row.get(key) for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    })
    marks.append(("end", time.monotonic()))
    phase_seconds = {a[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])
                     if b[1] - a[1] > 0.5}
    phase_seconds.update({k: v for k, v in phase_s.items() if v > 0.5})
    phase_seconds.pop("serving+graphs", None)
    summary("smoke", {"seconds": time.monotonic() - t_main,
                      "phase_seconds": phase_seconds})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
