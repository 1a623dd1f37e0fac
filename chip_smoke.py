#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA device and
``nvcc`` (``/usr/local/cuda`` or ``$CUDA_HOME``), and imports nothing of
JAX or of the JAX package.  Phases:

1. build: compile every CUDA kernel of the main path from the sources in
   the checkout (one ``nvcc`` per source, all at once), timed; then, in a
   child process that profiles once (a later profiler session in a
   process can lose every device record), the CUDA kernels of one call
   of each op at the paths' shapes (``rans_decode`` at the six streams
   of a chunk of lwm-7b's 3-layer groups, ``moe_experts`` at
   deepseek-moe-16b's batch-1 decode step), which must be what its source
   launches;
2. set-up: lwm-7b at full width (32 layers, d 4096, 32 heads, hd 128,
   ff 11008, vocab 32000) with random fp32 weights from a seeded
   ``torch.Generator``; a donor prefills a 512-token prefix and registers
   it, encoded by the host codec, in a ``KVStore``; its K/V are kept for
   phase 5b;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (``kv_restore_layers`` bit-equal on the path's
   first fetched chunk, 3 layers x 16 tokens, on a chunk of the 2-layer
   remainder group and with a real token in row 0 beside dropped tokens,
   and the single-layer ``kv_restore`` timed at one 8-token frame;
   ``paged_attention`` within 1e-4 at phase 4's batch of three, at phase
   5b's one request alone, at phase 5d's two requests together, at each
   decode step shape of phase 5c's fleet
   (``FLEET_BATCHES``) and at yi-34b's GQA head shape, each in block
   tables as wide as the cache's, with the number of page-axis splits
   and phase 1's kernels per call); times beside the bound (each
   kernel's row in the kernel table holds the means over the shapes of
   lwm-7b's and deepseek-moe-16b's paths weighted by their launches on
   the path; each shape is logged with its launches and loss);
   then the token-delta ops on the codec's real 240p planes of the
   prefix (``pack_frames`` of a fetched chunk and of layer group 0's
   whole prefix, 40 x 128 x 416): counts set to 0, one encode and one
   stack decode (``token_delta_decode_frames`` from a zero frame) of each
   channel, counts read; the results bit-equal to the plain versions, to
   the plain one-frame decode chained and to the numpy codec's
   ``ZIGZAG[plane_f - plane_{f-1}]``, every frame rebuilt, and group 0's
   stack decoded in two calls equal to one; then a random 64 x 1080 x
   1920 stack and an unaligned 5 x 5 x 77 stack, checked the same way and
   by the chained one-frame op; the decode timed at the path's stacks and
   the big one beside the chained one-frame decode in one graph, the
   plain version, its bound and (context only) a uint8 ``torch.cumsum``;
   then ``rans_decode`` on the rANS streams of the path's first fetched
   chunk, of a chunk of the remainder group and of a yi-9b-shaped chunk
   (1,024 tokens x 3 layers x 4 kv heads x 128 of the donor's K then V,
   encoded at 240p): byte-equal to the host's ``entropy.decode`` and to
   the plain version, one launch timed in a CUDA graph beside its byte
   bound (the chain of rounds, not bytes, sets its time), the whole call
   and both host decoders timed on the host clock;
3b. kernel: ``dense_3xtf32`` at ``DENSE_CASES`` (yi-9b's, lwm-7b's and
   deepseek-moe-16b's prefill products, q/k/v in one launch): the error
   of each output against an fp64 product (relative Frobenius norm) at
   most twice that of its plain version, ``torch.matmul`` in fp32, which
   is also the library yardstick; each timed in a CUDA graph beside its
   bound in 3xTF32 and in fp32 SIMT, with phase 1's one kernel per call;
   its launches on the path are the ``tc_products`` of every prefill span
   of phases 4 to 13, and no decode step launches it;
4. main path: a ``LiveEngine`` serves two requests that fetch the prefix
   and one plain request, 16 new tokens each; the kernels' launch counts
   are set to 0 just before and read just after, and must equal what the
   path implies (``rans_decode`` one launch per restored chunk, as
   ``kv_restore``); the restored pages must equal the codec's dequantized
   frames bit for bit;
5. virtual clock: the same weights and store behind a modeled WAN link
   (a constant ``BandwidthTrace``) and a decode table sized to the real
   blobs; one reuse request and one plain request, once with
   ``fetch_mode="sync"`` and once with ``"async"`` (pipelined transmit,
   decode and restore); per mode the counts are set to 0 before and read
   after, ``kv_restore`` and ``rans_decode`` must equal one fetch's
   restores, the restored pages must equal the codec's frames, the tokens
   must equal those of phase 4 for the same prompts, and the modeled TTFT
   of async must be below sync's, the plain request's below the reuse
   request's;
5b. storage tier: the same weights behind a two-node ``StorageCluster``
   (replication 1, manual heal) with a host-staging ``PrefetchManager``;
   only the prefix's first 256 tokens (the ancestor) are registered from
   the donor's KV.  R1 asks for all 512: a partial hit; the ancestor's
   node fails and R2 asks for the ancestor: a miss, whose tokens must
   equal a plain prefill's; the 512-token prefix is registered from the
   set-up's manifest; R3 asks for the ancestor: a full hit on the other
   node, which stages the prefix in host memory; R4 asks for the prefix:
   a host hit, whose tokens must equal phase 4's.  Per request the
   counts are set to 0 before and read after: ``kv_restore`` and
   ``rans_decode`` must equal the fetched chunks, ``paged_attention`` the
   layers times the decode steps; every fetch's pages must equal the
   codec's frames; the
   cluster's and the prefetcher's event logs, each request's TTFT and
   fetch time, and the phase's wall time are logged;
5c. fleet: a ``LiveFleet`` of 4 full-width engines sharing the one copy
   of the weights, on the virtual clock (sync fetches), behind the
   prefix-affinity router, one ``FairScheduler(max_inflight=1)`` and a
   two-node cluster (replication 1, manual heal) holding phase 5b's
   encoded 256-token ancestor and the set-up's 512-token prefix (no new
   encode); five prefix requests of three users and three plain ones,
   3 new tokens each: the ancestor fetched, its storage node failed
   (scripted by dispatch index), the ancestor restored locally
   (``local_restore``: a real restore at zero network time), the prefix
   fetched and restored locally, the ancestor missed once.  The counts
   are set to 0 before and read after, overall and per node:
   ``kv_restore`` and ``rans_decode`` must equal the chunks restored,
   ``paged_attention``
   the layers times each node's decode steps; every restore's pages
   must equal the codec's frames; tokens must equal phase 4's for its
   prompts, a local hit's the full hit's and the miss's those of a plain
   prefill of its prompt alone; every decode step's shape (contexts,
   block-table width) must be one of ``FLEET_BATCHES``, and all of them
   must occur; the router, fairness and
   cluster lookup logs and the local hits must equal those of the host
   ``FleetSimulator`` run on the same script.  Per request the node,
   hit kind, modeled and wall TTFT; per node the dispatches and
   launches; the peak memory and the phase's wall time are logged;
5d. mesh sharding: phase 5's link, decode table, weights and store
   behind a ``LiveEngine`` laid out on a (1, 1) ``DeviceMesh`` over
   ("data", "model") (``launch.mesh.make_debug_mesh``: a one-process
   group, nccl for the card) with ``mesh_shards=3``, so each fetch of 704
   chunks over 11 layer groups runs as three per-shard flows (4/4/3
   groups) through the one controller; one reuse and one plain request,
   ``sync`` then ``async``.  Per mode the counts are set to 0 before and
   read after: ``kv_restore`` and ``rans_decode`` must equal one fetch's
   chunks, ``paged_attention`` the layers times the decode steps; the
   fetch must
   split into three non-empty subplans; the restored pages must equal the
   codec's frames; the pages' DTensor views must be placed
   ``(Replicate(), Shard(3))`` and share the pages' storage; the tokens
   must equal phase 5's for the mode and phase 4's; no sharded fetch may
   stay tracked.  Each mode's modeled TTFTs beside phase 5's, the phase's
   wall time and peak memory are logged; the process group is destroyed
   at the end;
6. reference: the same engine at a reduced size on the card and on the
   CPU (plain versions) must generate the same tokens; so must the
   storage script of phase 5b, with equal cluster and prefetcher event
   logs, and a virtual-clock run of two users behind a
   ``FairScheduler``, with equal fairness and cluster event logs;
7. Mamba2 set-up: lwm-7b's weights are freed, then mamba2-2.7b at full
   width (64 layers, d 2560, d_inner 5120, 80 SSM heads of dim 64, state
   128, vocab 50280) with random fp32 weights from a seeded
   ``torch.Generator``, and a 2048-token prefix with two 16-token
   suffixes from ``numpy.random.default_rng``;
8. kernel: ``ssd_scan`` against its plain version on the card at the
   path's shapes (s 2048 and 2064, chunk 64) and at s 40, y and final
   state within 2e-4 of their largest magnitude, timed beside its bound
   (the larger of its bytes and its 3xTF32 tensor-core operations, with
   the fp32 SIMT figure beside it), with phase 1's count of two kernels
   per op call;
8b. backward: ``ssd_scan_bwd`` (the backward kernel, three launches,
   every product in 3xTF32 on the tensor cores: C.B^T once per piece and
   group, the sweeps over the pieces' states with the state in
   registers, then one block per piece and head; then two PyTorch sums
   over a group's heads) against its plain version ``ssd_scan_bwd_ref``
   and against ``torch.autograd`` through ``ssd_scan_ref`` on the card,
   from a seeded dy and a non-zero dstate at s 2048, 40 and 2064
   (padded): dxdt, da_log, dBm and dCm each within 2e-4 of its largest
   magnitude; timed in a CUDA graph beside its bound (the larger of its
   bytes and its 3xTF32 tensor-core operations, with the fp32 SIMT
   figure beside it) and the forward's time;
9. Mamba2 path (state-snapshot prefix reuse): a donor prefills the
   prefix; its recurrent state is snapshotted, encoded on the host,
   decoded, rebuilt on the card bit for bit, and two reuse requests
   (batched) feed their suffixes through ``decode_step`` and generate 16
   tokens; one plain request prefills prefix + suffix (2064 tokens) and
   generates 16.  ``ssd_scan``'s count is set to 0 just before and read
   just after and must be 2 prefills x 64 layers; the kernel's prefill
   logits must match the plain version's on the card within 2e-4 of the
   largest logit; the reuse-versus-exact-cache logit error is reported;
10. reference: the same snapshot path at a reduced size on the card
   (kernel) and on the CPU (plain version) must generate the same tokens;
10b. training: mamba2-2.7b at full width from ``training.steps.
   init_state`` (a seeded ``torch.Generator``; 2,830,951,936 fp32
   parameters, 42.18 GiB with gradients and AdamW's two moments), 4 steps
   of ``make_train_step`` (AdamW, cosine schedule, ``remat=True``) at
   b 1, s 2048 on ``data.pipeline.batches``.  Per step the counts are set
   to 0 just before and read just after: ``ssd_scan`` 128 (each layer's
   forward and its recompute), its backward 64.  Each loss and grad norm
   must be finite, step 0's loss within 1 of ln 50280, and every
   parameter leaf must have changed.  Logged: the median step time over
   steps 1-3, tokens/s, MFU (``roofline.analysis.model_flops`` over the
   step time at 67 TFLOP/s fp32, TF32 being off), peak memory, and one
   profiled step's device busy and idle share.  Then every training
   tensor is freed: less than 1 GiB may stay allocated;
11. MoE set-up: mamba2-2.7b's weights are freed, then deepseek-moe-16b at
   full width (28 layers, d 2048, 16 heads (MHA) of dim 128, a dense
   first layer of ff 10944, 27 MoE layers of 64 routed experts of ff 1408
   with 2 shared experts and top-6 routing, vocab 102400) with random
   fp32 weights from a seeded ``torch.Generator``, exactly 16,375,728,128
   parameters; a donor prefills phase 2's 512-token prefix and registers
   it, encoded, in a ``KVStore`` (28 layers: 9 groups of 3 and a group of
   one);
12. kernels at deepseek-moe-16b's shapes: ``kv_restore_layers`` bit-equal
   on the path's chunk of a 3-layer group and of the one-layer remainder
   group (16 tokens, H 16, D 128), and ``paged_attention`` within 1e-4
   at the batch of three (context 543, H = K = 16, hd 128); each timed
   beside its bound (``paged_attention`` also beside SDPA) and counted in
   the ``--kernel-counts`` child; ``rans_decode`` byte-equal and timed on
   the streams of the path's chunks of a 3-layer and of the one-layer
   group; ``moe_experts`` (the dropless layer's grouped experts) within
   1e-5 of its plain loop at one layer's weights, routed by its router,
   at decode batches of 1 and 3, suffixes of 16 and 256 and a 1,024-token
   prefill, with every token on one expert, and with the experts no
   token chose poisoned with NaN; each shape timed beside its bound;
13. the MoE path: phase 4's requests (two that fetch the prefix, one
   plain; 16-token suffixes, 16 new tokens) through deepseek-moe-16b's
   ``LiveEngine``, the counts set to 0 just before and read just after
   (``kv_restore`` and ``rans_decode`` one launch per fetched chunk,
   ``paged_attention`` 28 per decode step, ``moe_experts`` one call per
   ``moe`` span, each span's experts at most its choices); the restored
   pages bit-equal to the codec's dequantized frames; the plain request's
   first-token logits within 2e-4 of the largest |logit| of
   ``transformer.prefill`` of the same prompt on the card (at a capacity
   factor of E, so that no choice is dropped, as the engine's dropless
   layer drops none); the TTFTs, fetch times, median decode step, peak
   memory and whether reuse equals a full prefill (logged, not asserted:
   int8 KV) are logged;
14. reference: the reduced deepseek-moe-16b engine (4 layers: a dense
   first layer, groups of 3 and 1) generates the same tokens on the card
   and on the CPU; each of the ten ``ASSIGNED_ARCHS``, reduced, with
   weights drawn on the CPU: ``forward_full`` on the card against the
   CPU (logits within 2e-4 of the largest, aux within 1e-5) and, for the
   decoders, ``prefill`` of a 72-token prompt (past the reduced 64-token
   windows) and 4 ``decode_step``; an argmax or a top-k routing choice
   that differs is logged with its margin;
14b. reference: one ``make_train_step`` of each of the ten reduced
   ``ASSIGNED_ARCHS`` from weights drawn on the CPU and the same batch,
   on the card and on the CPU: loss and grad norm within 2e-4 relative,
   the updated parameters within 5e-3 (lr 1e-3); reduced mamba2 trains
   through ``ssd_scan`` and its backward kernel.
15. dry run: ``torch.library.opcheck`` of the custom ops
   ``repro_torch::ssd_scan_fwd`` and ``ssd_scan_bwd`` on CUDA inputs (b 2,
   s 128 and 100, nh 4, hd 32, S 16), which holds the fake implementation
   against the kernels' outputs and must launch both; then, each in a
   child process (its fake group of 256 or 512 ranks apart from phase
   5d's group), ``python -m repro_torch.launch.dryrun`` for mamba2-2.7b x
   prefill_32k x single and yi-9b x decode_32k x multipod at full width
   on the production meshes over device type cuda: each ``ok``, 64
   ``ssd_scan_fwd`` calls in the mamba2 trace, the card's allocated bytes
   equal before and after the trace (nothing allocated); the roofline
   terms (modeled for the H100 SXM's peaks), dominant term, collectives
   by family and trace seconds are logged (``[dryrun]`` lines).

TF32 is switched off for matrix products and convolutions, so every fp32
product runs in full fp32.  Any failed check raises and the script exits
non-zero.  The last lines are the kernel table as JSON, the card's name
and power limit, and the result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch is missing)")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro_torch.cluster.costmodel import CHIPS, EngineCostModel  # noqa: E402
from repro_torch.cluster.fairness import FairScheduler  # noqa: E402
from repro_torch.cluster.fleet import (  # noqa: E402
    FleetSimulator, LiveFleet)
from repro_torch.cluster.network import BandwidthTrace  # noqa: E402
from repro_torch.cluster.simulator import MethodSpec  # noqa: E402
from repro_torch.cluster.staging import (  # noqa: E402
    HostStagingTier, PrefetchManager)
from repro_torch.cluster.storage import (  # noqa: E402
    KVStore, StorageCluster, StorageNode, StoredPrefix)
from repro_torch.configs import (  # noqa: E402
    ASSIGNED_ARCHS, InputShape, get_config, reduce_config)
from repro_torch.core import entropy  # noqa: E402
from repro_torch.core.chunks import (  # noqa: E402
    decode_chunk_tokens, decode_state_snapshot, encode_prefix,
    encode_state_snapshot, prefix_key)
from repro_torch.core.codec import KVCodec  # noqa: E402
from repro_torch.core.adaptive import DecodeTable  # noqa: E402
from repro_torch.core.layout import (  # noqa: E402
    IntraLayout, frame_geometry, pack_frames)
from repro_torch.core.prediction import UNZIGZAG, ZIGZAG  # noqa: E402
from repro_torch.core.quantization import quantize  # noqa: E402
from repro_torch.core.scheduler import Request  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batches  # noqa: E402
from repro_torch.data.workload import shared_prefix_tokens  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.dense_3xtf32 import ops as dense_ops  # noqa: E402
from repro_torch.kernels.dense_3xtf32.ref import dense_ref  # noqa: E402
from repro_torch.kernels.kv_restore import ops as kv_ops  # noqa: E402
from repro_torch.kernels.kv_restore.ref import (  # noqa: E402
    kv_restore_layers_ref, kv_restore_ref)
from repro_torch.kernels.moe_experts import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_experts.ref import moe_experts_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.rans_decode import ops as rans_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.token_delta import ops as td_ops  # noqa: E402
from repro_torch.kernels.token_delta.ref import (  # noqa: E402
    token_delta_decode_frame_ref, token_delta_decode_frames_ref,
    token_delta_encode_ref)
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.roofline.analysis import model_flops  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import paged_model, tracing  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamW, constant_schedule, cosine_schedule)
from repro_torch.training.steps import (  # noqa: E402
    TrainState, init_state, make_train_step)
from repro_torch.tree import flatten, leaves, tree_map  # noqa: E402

SEED = 0
PREFIX_TOKENS = 512
SUFFIX_TOKENS = 16
NEW_TOKENS = 16
TOKENS_PER_CHUNK = 16
RESOLUTION = "240p"
N_PAGES = 128
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores
ATTN_TOL = 1e-4
MAMBA_PREFIX = 2048
SCAN_CHUNK = 64               # apply_ssm_full's chunk
SCAN_TOL = 2e-4               # of the largest |y| or |state|
LOGIT_TOL = 2e-4              # of the largest |logit|
TRAIN_STEPS = 4               # phase 10b: full-width mamba2-2.7b steps
MAMBA_PARAMS = 2_830_951_936  # its leaves (param_count(): 2,830,442,496)
TRAIN_LR = 3e-4
TRAIN_TOL = 2e-4              # phase 14b: loss and grad norm, relative
PARAM_ATOL = 5e-3             # phase 14b: updated params at lr 1e-3
BIG_STACK = (64, 1080, 1920)  # a bandwidth-sized uint8 stack, 133 MB
PLANE_STACK = (40, 128, 416)  # group 0's 240p plane stack of the prefix
ODD_STACK = (5, 5, 77)        # H*W not a multiple of 16
# the virtual-clock phase: one host rANS decoder whose modeled latency per
# 16-token chunk is about what the host codec takes per chunk on the card's
# host (10-17 s for the prefix's 704 chunks, PERF.md), and a link at which
# one chunk's transmit takes as long as its decode, so that pipelining the
# two shows
VIRTUAL_DECODE_S = 0.02
PAGE_SIZE = 16


def table_width(prompt_len: int, new_tokens: int) -> int:
    """Pages in a sequence's block table: the engine gives each request
    rows for its prompt and its new tokens when it is admitted."""
    return -(-(prompt_len + new_tokens) // PAGE_SIZE)


# the decode contexts at the main path's last step: prefix + suffix + new
# tokens - 1, for the two reuse requests and the plain one
DECODE_CTX = [PREFIX_TOKENS + SUFFIX_TOKENS + NEW_TOKENS - 1] * 3
# their block tables' width
DECODE_WIDTH = table_width(PREFIX_TOKENS + SUFFIX_TOKENS, NEW_TOKENS)
# the storage phase's decode context at its last step: one request alone
STORAGE_CTX = DECODE_CTX[:1]
# the sharded phase: per-shard flows a fetch runs as (lwm-7b's 11 layer
# groups split 4/4/3), and its decode contexts at the last step of a batch
# of two (sync mode: the reuse and the plain request together)
MESH_SHARDS = 3
SHARDED_CTX = DECODE_CTX[:2]
# the fleet phase: serving nodes, new tokens per request, and the kinds of
# cluster event whose order the dispatch sequence alone sets (a missed
# prefix's re-admission rides on its prefill's first token, a clock)
FLEET_NODES = 4
FLEET_NEW_TOKENS = 3
FLEET_LOOKUP_KINDS = ("full", "partial", "miss", "fail", "recover",
                      "replicate")
# the fleet's decode steps, as the affinity node and the plain nodes batch
# them on the modeled clock (which alone sets them, so they are the same
# in every run).  A (the ancestor, half the prefix) and P (the
# prefix) each with the suffix; the plain prompt is as long as P's
FLEET_A = PREFIX_TOKENS // 2 + SUFFIX_TOKENS
FLEET_P = PREFIX_TOKENS + SUFFIX_TOKENS


def decode_batch(*seqs) -> tuple:
    """One decode step over sequences given as (prompt length, index of
    the token the step makes): (their contexts, sorted; the width of the
    step's block tables)."""
    return (tuple(sorted(n + k for n, k in seqs)),
            max(table_width(n, FLEET_NEW_TOKENS) for n, _ in seqs))


FLEET_BATCHES = (decode_batch((FLEET_A, 1)),
                 decode_batch((FLEET_A, 1), (FLEET_A, 2)),
                 decode_batch((FLEET_A, 2)),
                 decode_batch((FLEET_A, 1), (FLEET_P, 2)),
                 decode_batch((FLEET_A, 2), (FLEET_P, 1)),
                 decode_batch((FLEET_P, 1)),
                 decode_batch((FLEET_P, 1), (FLEET_P, 2)),
                 decode_batch((FLEET_P, 2)))
# the MoE path of phases 11-13: deepseek-moe-16b at full width, and its
# parameter count (the JAX init's tree, counted by jax.eval_shape)
DS_ARCH = "deepseek-moe-16b"
DS_PARAMS = 16_375_728_128
# paged_attention's cases, held, timed and counted at the paths' shapes:
# (case, config, decode contexts, block-table width, seed); deepseek's
# batch of three is held in phase 12
ATTN_CASES = ((("lwm-7b", "lwm-7b", DECODE_CTX, DECODE_WIDTH, 2),
               ("lwm-7b B=1", "lwm-7b", STORAGE_CTX, DECODE_WIDTH, 4),
               ("lwm-7b B=2", "lwm-7b", SHARDED_CTX, DECODE_WIDTH, 21),
               ("yi-34b", "yi-34b", DECODE_CTX, DECODE_WIDTH, 3),
               (DS_ARCH, DS_ARCH, DECODE_CTX, DECODE_WIDTH, 20))
              + tuple((f"lwm-7b fleet ctx {list(lens)} w {width}", "lwm-7b",
                       list(lens), width, 7 + i)
                      for i, (lens, width) in enumerate(FLEET_BATCHES)))


def log(*a) -> None:
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def graph_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph and
    replayed, so the host's launch cost between calls is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=1, reps=reps) / iters


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``reps`` calls of ``fn``, in ms."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_inputs(dev, H, K, hd, ps, lens, width, seed):
    """Decode attention over block tables ``width`` pages wide, as the
    cache lays them out: (q, k_pages, v_pages, block_tables,
    context_lens)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    P = B * width
    q = torch.randn(B, H, hd, device=dev, generator=g)
    kp = torch.randn(P, ps, K, hd, device=dev, generator=g)
    vp = torch.randn(P, ps, K, hd, device=dev, generator=g)
    bt = torch.randperm(P, device=dev, generator=g)
    bt = bt.reshape(B, width).to(torch.int32)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, cl


def count_kernels_child() -> int:
    """``chip_smoke.py --kernel-counts``: one profiled call of each op
    that a path launches at the path's shapes (seeded inputs), each in
    its own ``record_function`` range; prints, as JSON, the launches on
    the host inside each range and how many of them have a kernel record
    on the device, and the page-axis splits of ``paged_attention``."""
    dev = torch.device("cuda", 0)
    mamba = get_config("mamba2-2.7b")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    slots = torch.arange(TOKENS_PER_CHUNK, dtype=torch.int32, device=dev)
    calls, splits = {}, {}
    # a chunk of lwm-7b's 3-layer groups, and deepseek-moe-16b's chunks of
    # a 3-layer group and of its 1-layer remainder group
    for name, arch, G in (("kv_restore_layers", "lwm-7b", 3),
                          (f"kv_restore_layers {DS_ARCH} G=3", DS_ARCH, 3),
                          (f"kv_restore_layers {DS_ARCH} G=1", DS_ARCH, 1)):
        cfg = get_config(arch)
        H, D = cfg.num_kv_heads, cfg.head_dim
        pages = torch.zeros(cfg.num_layers, N_PAGES * 16, H, D, device=dev)
        q = torch.randint(0, 256, (G, TOKENS_PER_CHUNK, H, D), device=dev,
                          generator=g, dtype=torch.uint8)
        scales = torch.rand(G, H, device=dev, generator=g)
        calls[name] = (lambda a=(pages, tuple(range(G)), q, scales, slots):
                       kv_ops.kv_restore_layers(*a))
    for case, arch, lens, width, seed in ATTN_CASES:
        cfg = get_config(arch)
        args = attention_inputs(dev, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, PAGE_SIZE, lens, width, seed)
        name = f"paged_attention {case}"
        calls[name] = lambda a=args: pa_ops.paged_attention(*a)
        splits[name] = pa_ops.plan_splits(
            len(lens), cfg.num_heads, cfg.num_kv_heads,
            args[3].shape[1], pa_ops._sm_count(dev))
    scan = scan_inputs(dev, 1, MAMBA_PREFIX, mamba.ssm_nheads,
                       mamba.ssm_head_dim, mamba.ssm_ngroups, mamba.ssm_state,
                       SEED + 6)
    calls["ssd_scan"] = lambda: ssd_ops.ssd_scan(*scan, chunk=SCAN_CHUNK)
    dy = torch.randn(scan[0].shape, device=dev, generator=g)
    dstate = torch.randn(1, mamba.ssm_nheads, mamba.ssm_head_dim,
                         mamba.ssm_state, device=dev, generator=g)
    calls["ssd_scan_bwd"] = lambda: ssd_ops.ssd_scan_bwd(
        *scan, dy, dstate, chunk=SCAN_CHUNK)
    video = torch.randint(0, 256, PLANE_STACK, device=dev, generator=g,
                          dtype=torch.uint8)
    zero = torch.zeros_like(video[0])
    calls["token_delta_encode"] = lambda: td_ops.token_delta_encode(video)
    calls["token_delta_decode_frames"] = (
        lambda: td_ops.token_delta_decode_frames(zero, video))
    # the six streams of a chunk of lwm-7b's 3-layer groups at 240p
    lwm = get_config("lwm-7b")
    codec = KVCodec(lwm.num_kv_heads, lwm.head_dim)
    q = np.random.default_rng(SEED + 7).integers(
        0, 256, (TOKENS_PER_CHUNK, 3, lwm.num_kv_heads, lwm.head_dim),
        dtype=np.uint8)
    streams = codec.rans_streams(codec.encode_chunk(q, RESOLUTION))
    calls["rans_decode"] = lambda: rans_ops.rans_decode_streams(streams, dev)
    # deepseek-moe-16b's experts at a batch-1 decode step
    ds = get_config(DS_ARCH)
    E, d, ff = ds.num_experts, ds.d_model, ds.d_ff
    wi = torch.randn(E, d, 2, ff, device=dev, generator=g) * d ** -0.5
    wo = torch.randn(E, ff, d, device=dev, generator=g) * ff ** -0.5
    xm = torch.randn(1, d, device=dev, generator=g)
    ids = torch.randperm(E, device=dev, generator=g)[
        :ds.experts_per_token][None].contiguous()
    wts = torch.rand(1, ds.experts_per_token, device=dev, generator=g)
    calls["moe_experts"] = lambda: moe_ops.moe_experts(xm, ids, wts, wi, wo)
    # lwm-7b's q/k/v at the donor's 512-token prefill, one launch
    xd = torch.randn(PREFIX_TOKENS, lwm.d_model, device=dev, generator=g)
    wd = [torch.randn(lwm.d_model, lwm.d_model, device=dev, generator=g)
          for _ in range(3)]
    calls["dense_3xtf32"] = lambda: dense_ops.dense_3xtf32(xd, wd)
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for name, fn in calls.items():
            with torch.profiler.record_function(name):
                fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    on_device = torch.autograd.DeviceType.CUDA
    recorded = {e.correlation_id() for e in events
                if e.device_type() == on_device
                and not e.is_user_annotation()}
    launches = [e for e in events
                if e.device_type() != on_device and "Launch" in e.name()]
    out = {}
    for e in events:
        if e.device_type() != on_device and e.name() in calls:
            mine = [x for x in launches
                    if e.start_ns() <= x.start_ns() <= e.end_ns()]
            out[e.name()] = dict(
                launches=len(mine),
                kernels=sum(x.correlation_id() in recorded for x in mine),
                splits=splits.get(e.name()))
    print(json.dumps(out), flush=True)
    return 0


def kernel_counts() -> dict:
    """CUDA kernels per op call as the profiler sees them on the device,
    each checked against what the op's source launches.

    Counted in a child process whose only profiler session this is: in a
    process that has profiled once, a later session can come back without
    any device record (even for PyTorch's own kernels), most often after
    tens of seconds of other work, so a count taken there is no count."""
    out = subprocess.run([sys.executable, str(pathlib.Path(__file__)),
                          "--kernel-counts"], capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f"kernel count failed:\n{out.stderr}")
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    for name, c in counts.items():
        # what the sources launch: kv_restore one kernel, ssd_scan C.B^T
        # then the scan, its backward C.B^T, the sweeps and the pieces
        # (and two PyTorch sums of dB and dC over a group's heads), the
        # token-delta ops one kernel per stack, rans_decode one kernel per
        # chunk, paged_attention its split kernel and, when it splits the
        # pages, the merge, moe_experts the sort, the gate-up and down
        # products and the PyTorch sum over each token's choices,
        # dense_3xtf32 one kernel for all of a call's weights
        want = {"ssd_scan": 2, "ssd_scan_bwd": 5, "token_delta_encode": 1,
                "token_delta_decode_frames": 1, "rans_decode": 1,
                "moe_experts": 4, "dense_3xtf32": 1}.get(
            name, 1 if name.startswith("kv_restore") or c["splits"] == 1
            else 2)
        log(f"[profile] {name}: {c['kernels']} CUDA kernels per op call "
            f"with a device record, {c['launches']} launches on the host"
            + (f"; {c['splits']} splits" if c["splits"] else ""))
        check(c["launches"] == c["kernels"] == want,
              f"{name}: {c['kernels']} kernels on the device for "
              f"{c['launches']} launches, the source launches {want}")
    return counts


# -- phase 2: model, donor, store --------------------------------------------

def n_params(params) -> int:
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(n_params(v) for v in params)
    return params.numel()


def set_up(dev, arch: str = "lwm-7b", tag: str = "setup"):
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    torch.cuda.synchronize()
    log(f"[{tag}] {arch} full width, {n_params(params)} fp32 params "
        f"({n_params(params) * 4 / 2**30:.2f} GiB), init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, PREFIX_TOKENS,
                                           2, SUFFIX_TOKENS)
    plain = rng.integers(0, cfg.vocab_size, PREFIX_TOKENS + SUFFIX_TOKENS)
    t0 = time.perf_counter()
    logits, kvs = paged_model.prefill_collect_kv(
        params, cfg, torch.as_tensor(prefix[None], device=dev))
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "donor logits not finite")
    kv_k = torch.stack([k[0] for k, _ in kvs], 1).cpu().numpy()
    kv_v = torch.stack([v[0] for _, v in kvs], 1).cpu().numpy()
    del kvs
    t_prefill = time.perf_counter() - t0
    store = KVStore()
    t0 = time.perf_counter()
    man = store.register_prefix(prefix, kv_k, kv_v,
                                tokens_per_chunk=TOKENS_PER_CHUNK,
                                resolutions=(RESOLUTION,))
    log(f"[{tag}] donor prefill {PREFIX_TOKENS} tokens {t_prefill:.2f} s; "
        f"host encode {time.perf_counter() - t0:.2f} s, "
        f"{store.stored_bytes()} bytes in {len(man.refs)} chunks, "
        f"layout {man.layout}")
    return cfg, params, store, man, prefix, prompts, plain, kv_k, kv_v


# -- phase 3: kernels against their plain versions ---------------------------

def chunk_tokens(cfg, man, ref):
    """One fetched chunk as the engine stages it: every frame decoded, the
    frames' tokens concatenated, layer-major [G, n, H, D]; with the
    tokens' positions in the chunk and the first frame's token count."""
    lay = IntraLayout(cfg.num_kv_heads, cfg.head_dim, *man.layout)
    codec = KVCodec(cfg.num_kv_heads, cfg.head_dim, lay)
    frames = list(codec.iter_decode_frames(
        man.blobs[(ref.chunk_id, RESOLUTION)]))
    q = np.concatenate([qt for _, qt in frames], axis=0)
    return (np.concatenate([toks for toks, _ in frames]),
            np.ascontiguousarray(q.swapaxes(0, 1)), len(frames[0][0]))


def kv_restore_phase(dev, cfg, man, n_kernels: int, frame_timing: bool):
    """``kv_restore_layers`` against its plain version on the card at
    ``cfg``'s path, each chunk shape timed beside its bound.  Returns the
    kernel row, with ``by_group``: per group size G (layers in a chunk's
    group), the row's times at the path's chunk of that size."""
    H, D, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    R = N_PAGES * 16
    g = torch.Generator(device=dev).manual_seed(1)
    pages = torch.randn(L, R, H, D, device=dev, generator=g)
    # the path's first chunk (a 3-layer group) and a chunk of the
    # remainder group, with distinct rows >= 1, so row 0 below is unique
    cases, frame_len = [], 0
    for ref in (man.refs[0], next(r for r in man.refs if len(r.layers) < 3)):
        toks, q, first_len = chunk_tokens(cfg, man, ref)
        rows = (torch.randperm(R - 1, device=dev, generator=g)[:len(toks)]
                + 1).to(torch.int32)
        l0 = ref.layers[0]
        scales = torch.as_tensor(
            man.scales[ref.kind][l0:l0 + len(ref.layers)], device=dev)
        cases.append((f"chunk {ref.chunk_id}", ref.layers,
                      torch.as_tensor(q, device=dev), scales, rows))
        frame_len = frame_len or first_len
    what, layers, q, scales, rows = cases[0]
    dropped = rows.clone()
    dropped[0] = 0
    dropped[1::3] = -1
    cases.append(("slot 0 beside dropped tokens", layers, q, scales,
                  dropped))
    err = 0.0
    for what, layers_c, q_c, scales_c, sl in cases:
        want = kv_restore_layers_ref(pages.clone(), layers_c, q_c, scales_c,
                                     sl)
        got = kv_ops.kv_restore_layers(pages.clone(), layers_c, q_c,
                                       scales_c, sl)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"{cfg.name}: kv_restore_layers kernel != plain version "
              f"({what})")
        err = max(err, (got - want).abs().max().item())
    by_group = {}
    for what, layers_c, q_c, scales_c, rows_c in cases[:2]:
        G, n = q_c.shape[:2]

        def call():
            kv_ops.kv_restore_layers(pages, layers_c, q_c, scales_c, rows_c)
        ms = graph_ms(call)
        eager_ms = time_ms(call)
        # the plain version's boolean-mask scatter synchronises with the
        # host, so it cannot be captured: its time includes that round trip
        plain_ms = time_ms(lambda: kv_restore_layers_ref(
            pages, layers_c, q_c, scales_c, rows_c))
        n_bytes = G * n * H * D * (1 + 4) + G * H * 4 + n * 4
        b_ms, b_by = bound(n_bytes, 2 * G * n * H * D)
        by_group[G] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
        log(f"[kernel] kv_restore_layers {cfg.name} G={G} n={n} H={H} D={D} "
            f"(one chunk, layers {tuple(layers_c)}): bit-equal in "
            f"{len(cases)} cases (the path's first chunk, a "
            f"{len(cases[1][1])}-layer remainder chunk, slot 0 beside "
            f"dropped tokens); {n_kernels} CUDA kernel per call; {G * n} "
            f"blocks; device {ms * 1e3:.2f} us/launch (eager call from "
            f"Python {eager_ms * 1e3:.2f} us; plain version "
            f"{plain_ms * 1e3:.2f} us eager; bound {b_ms * 1e3:.4f} us by "
            f"{b_by}, {n_bytes} bytes)")
    if frame_timing:
        # the shape of one launch when each layer of each frame was
        # restored on its own: one layer of one 8-token frame
        one, frame = pages[0], q[0, :frame_len]
        s1 = scales[0].contiguous()
        r1 = rows[:frame_len].contiguous()
        ms1 = graph_ms(lambda: kv_ops.kv_restore(one, frame, s1, r1))
        eager1 = time_ms(lambda: kv_ops.kv_restore(one, frame, s1, r1))
        plain1 = time_ms(lambda: kv_restore_ref(one, frame, s1, r1))
        n1 = frame_len
        b1, b1_by = bound(n1 * H * D * (1 + 4) + H * 4 + n1 * 4,
                          2 * n1 * H * D)
        log(f"[kernel] kv_restore n={n1} H={H} D={D} (one layer of one "
            f"frame, the per-layer shape before one launch per chunk): "
            f"device {ms1 * 1e3:.2f} us/launch (eager call "
            f"{eager1 * 1e3:.2f} us; plain version {plain1 * 1e3:.2f} us "
            f"eager; bound {b1 * 1e3:.4f} us by {b1_by})")
        # the floor under both: one PyTorch kernel on 16 bytes,
        # graph-replayed
        tiny = torch.zeros(4, device=dev)
        floor_ms = graph_ms(lambda: tiny.add_(1.0))
        log(f"[kernel] launch floor: one PyTorch kernel on 16 bytes, device "
            f"{floor_ms * 1e3:.2f} us/launch in a CUDA-graph replay")
    del pages
    torch.cuda.empty_cache()
    return dict(by_group[len(layers)], name="kv_restore", route="cuda",
                source="src/repro_torch/kernels/kv_restore/kv_restore.cu",
                replaces="src/repro/kernels/kv_restore/kv_restore.py:35",
                max_abs_err=err, library_ms=None, by_group=by_group)


def rans_case(dev, streams) -> dict:
    """``rans_decode_streams`` on the card against the host's numpy decoder
    (``entropy.decode``) and against its plain version (the op on the CPU:
    ``ref.rans_decode_ref``), byte for byte; then one launch timed in a
    CUDA graph, the whole call (pack, pinned upload, launch, wait,
    readback) and both host decoders on the host clock, and the bound."""
    parsed = [entropy.parse_stream(st) for st in streams]
    want = [entropy.decode(st) for st in streams]
    t0 = time.perf_counter()
    plain = rans_ops.rans_decode_streams(streams, "cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = rans_ops.rans_decode_streams(streams, dev)
    for i, (w, p, g) in enumerate(zip(want, plain, got)):
        check(np.array_equal(p.numpy(), w),
              f"rans_decode plain version != entropy.decode (stream {i})")
        check(np.array_equal(g.numpy(), w),
              f"rans_decode kernel != entropy.decode (stream {i})")
    packed = rans_ops.pack(parsed)
    dev_in = packed.host_in.to(dev)
    dev_out = torch.empty(packed.out_bytes, dtype=torch.uint8, device=dev)
    ms = graph_ms(lambda: rans_ops.launch(dev_in, dev_out, len(packed.live),
                                          packed.threads))
    call_ms = host_ms(lambda: rans_ops.rans_decode_streams(streams, dev), 20)
    numpy_ms = host_ms(lambda: [entropy.decode(st) for st in streams], 3)
    symbols = sum(st.n for st in parsed)
    n_bytes = sum(len(st) for st in streams) + symbols
    b_ms, b_by = bound(n_bytes, 0)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                call_ms=call_ms, numpy_ms=numpy_ms, symbols=symbols,
                n_bytes=n_bytes, blocks=len(packed.live),
                rounds=max(-(-st.n // st.lanes) for st in parsed))


def rans_log(what: str, c: dict, n_kernels: int) -> None:
    log(f"[kernel] rans_decode {what}: byte-equal to entropy.decode and to "
        f"the plain version; {n_kernels} CUDA kernel per call, "
        f"{c['blocks']} blocks; {c['symbols']} symbols, {c['rounds']} "
        f"rounds in the longest stream; device {c['ms'] * 1e3:.2f} us/launch"
        f" ({c['ms'] * 1e6 / c['rounds']:.0f} ns a round); the whole call "
        f"{c['call_ms'] * 1e3:.2f} us; host numpy decode "
        f"{c['numpy_ms']:.2f} ms; plain version {c['plain_ms']:.2f} ms on "
        f"the host; bound {c['bound_ms'] * 1e3:.4f} us by {c['bound_by']} "
        f"({c['n_bytes']} bytes; the chain of rounds sets the time)")


def rans_decode_phase(dev, cfg, man, n_kernels: int, kv=None):
    """``rans_decode`` at ``cfg``'s path: the streams of the path's first
    fetched chunk (a 3-layer group) and of a chunk of the remainder group,
    as the store holds them, each through ``rans_case``.  With ``kv`` (the
    donor's K and V), also a yi-9b-shaped chunk: layers 0-2 and kv heads
    0-3 of K then V, 1,024 tokens, quantised and encoded at 240p.  Returns
    the kernel row, with ``by_group`` as ``kv_restore_phase``'s."""
    codec = KVCodec(cfg.num_kv_heads, cfg.head_dim)
    by_group = {}
    for ref in (man.refs[0], next(r for r in man.refs if len(r.layers) < 3)):
        c = rans_case(dev, codec.rans_streams(
            man.blobs[(ref.chunk_id, RESOLUTION)]))
        by_group[len(ref.layers)] = c
        rans_log(f"{cfg.name} G={len(ref.layers)} (chunk {ref.chunk_id}, "
                 f"{ref.token_end - ref.token_start} tokens)", c, n_kernels)
    if kv is not None:
        q, _ = quantize(np.concatenate([k[:, :3, :4] for k in kv]))
        check(q.shape == (2 * PREFIX_TOKENS, 3, 4, 128),
              f"the yi-9b-shaped chunk is {q.shape}")
        yi = KVCodec(4, 128, IntraLayout(4, 128, 2, 1))
        blob = yi.encode_chunk(q, RESOLUTION)
        rans_log(f"yi-9b-shaped chunk ({q.shape[0]} tokens x 3 layers x 4 kv "
                 f"heads x 128 of {cfg.name}'s donor K and V, "
                 f"{yi.frame_count(blob)} frames)",
                 rans_case(dev, yi.rans_streams(blob)), n_kernels)
    return dict(by_group[3], name="rans_decode", route="cuda",
                source="src/repro_torch/kernels/rans_decode/rans_decode.cu",
                replaces="none (host numpy: src/repro/core/entropy.py:147)",
                max_abs_err=0.0, library_ms=None, by_group=by_group)


def restores_by_group(man) -> dict:
    """The share of a fetch's ``kv_restore`` launches at each group size:
    every layer group holds the same chunk positions, so a group of G
    layers takes (groups of G) / (groups) of the launches of any fetch,
    whole or partial."""
    sizes = [len(g) for g in man.layer_groups]
    return {G: sizes.count(G) / len(sizes) for G in set(sizes)}


def paged_attention_case(dev, H, K, hd, ps, lens, width, seed,
                         n_kernels: int):
    q, kp, vp, bt, cl = attention_inputs(dev, H, K, hd, ps, lens, width,
                                         seed)
    B, bps = bt.shape
    want = paged_attention_ref(q, kp, vp, bt, cl)
    got = pa_ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= ATTN_TOL, f"paged_attention kernel off by {err}")
    n_split = pa_ops.plan_splits(B, H, K, bps, pa_ops._sm_count(q.device))
    ms = graph_ms(lambda: pa_ops.paged_attention(q, kp, vp, bt, cl))
    eager_ms = time_ms(lambda: pa_ops.paged_attention(q, kp, vp, bt, cl))
    plain_ms = graph_ms(lambda: paged_attention_ref(q, kp, vp, bt, cl))
    # library yardstick: SDPA over K/V already gathered into [B, H, S, hd]
    S = bps * ps
    kd = kp[bt.long()].reshape(B, S, K, hd).permute(0, 2, 1, 3)
    vd = vp[bt.long()].reshape(B, S, K, hd).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(H // K, dim=1).contiguous()
    vd = vd.repeat_interleave(H // K, dim=1).contiguous()
    mask = (torch.arange(S, device=dev)[None] < cl[:, None])[:, None, None]
    qd = q[:, :, None]
    lib = torch.nn.functional.scaled_dot_product_attention(qd, kd, vd,
                                                          attn_mask=mask)
    check((lib[:, :, 0] - want).abs().max().item() <= ATTN_TOL,
          "SDPA yardstick disagrees")
    library_ms = graph_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qd, kd, vd,
                                                      attn_mask=mask))
    ctx = sum(lens)
    n_bytes = 2 * ctx * K * hd * 4 + 2 * B * H * hd * 4 \
        + 4 * sum(-(-n // ps) for n in lens) + 4 * B
    b_ms, b_by = bound(n_bytes, 4 * ctx * H * hd + 5 * ctx * H)
    log(f"[kernel] paged_attention H={H} K={K} hd={hd} ps={ps} ctx={lens} "
        f"width {bps}: "
        f"n_split {n_split} "
        f"({B * K * -(-(H // K) // pa_ops.HEAD_TILE) * n_split} blocks), "
        f"{n_kernels} "
        f"CUDA kernels per op call; "
        f"max_abs_err {err:.3g}, device {ms * 1e3:.2f} us/call (eager "
        f"call {eager_ms * 1e3:.2f} us; plain version {plain_ms * 1e3:.2f} "
        f"us; SDPA on K/V already gathered {library_ms * 1e3:.2f} us; bound "
        f"{b_ms * 1e3:.3f} us by {b_by})")
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/kernels/paged_attention/"
                       "paged_attention.cu",
                replaces="src/repro/kernels/paged_attention/"
                         "paged_attention.py:71",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def prefix_planes(cfg, man):
    """The codec's 240p planes of the prefix, as ``pack_frames`` lays them
    out: (name, [F, FH, FW] uint8 per channel) for one fetched chunk and
    for layer group 0's whole prefix of K packed as one chunk."""
    lay = IntraLayout(cfg.num_kv_heads, cfg.head_dim, *man.layout)
    codec = KVCodec(cfg.num_kv_heads, cfg.head_dim, lay)
    group0 = [r for r in man.refs if r.kind == "k" and r.group == 0]
    chunks = [codec.decode_chunk(man.blobs[(r.chunk_id, RESOLUTION)])
              for r in group0]
    out = []
    for name, q in (("chunk", chunks[0]),
                    ("group0", np.concatenate(chunks, axis=0))):
        # the codec codes a group's (up to) 3 layers as 3 channels
        q = np.concatenate([q, np.zeros((q.shape[0], 3 - q.shape[1])
                                        + q.shape[2:], np.uint8)], axis=1)
        geom = frame_geometry(q.shape[0], lay, RESOLUTION)
        video = pack_frames(q, lay, geom)  # [F, FH, FW, 3]
        out.append((name, [np.ascontiguousarray(video[..., c])
                           for c in range(video.shape[-1])]))
    return out


def delta_bound(n_bytes: float):
    """Bytes moved, and about three integer operations per byte."""
    return bound(n_bytes, 3 * n_bytes)


def chained_ref(prev, zres):
    """The plain one-frame decode chained over the frames."""
    frames = []
    for f in range(zres.shape[0]):
        prev = token_delta_decode_frame_ref(prev, zres[f])
        frames.append(prev)
    return torch.stack(frames)


def check_decoded(what, frames, video, zres, prev) -> None:
    """A decoded stack: bit-equal to the stack it came from, to the plain
    version and to the plain one-frame decode chained."""
    check(torch.equal(frames, video), f"stack decode lost a frame ({what})")
    check(torch.equal(frames, token_delta_decode_frames_ref(prev, zres)),
          f"token_delta_decode_frames != plain version ({what})")
    check(torch.equal(frames, chained_ref(prev, zres)),
          f"token_delta_decode_frames != chained one-frame decode ({what})")


def token_delta_phase(dev, cfg, man):
    planes = prefix_planes(cfg, man)
    # the path: every channel plane encoded in one launch, then decoded in
    # one launch from a zero reference frame
    torch.cuda.synchronize()
    td_ops.encode_launches = 0
    td_ops.decode_launches = 0
    results = []
    for name, chans in planes:
        for c, plane in enumerate(chans):
            video = torch.as_tensor(plane, device=dev)
            zres = td_ops.token_delta_encode(video)
            frames = td_ops.token_delta_decode_frames(
                torch.zeros_like(video[0]), zres)
            results.append((f"{name} channel {c}", plane, video, zres,
                            frames))
    torch.cuda.synchronize()
    launches = {"token_delta_encode": td_ops.encode_launches,
                "token_delta_decode_frames": td_ops.decode_launches}
    check(launches == dict.fromkeys(launches, len(results)),
          f"token_delta launches {launches}, {len(results)} plane stacks")
    for what, plane, video, zres, frames in results:
        # the codec's TEMPORAL candidate: ZIGZAG[plane_f - plane_{f-1}]
        ref = np.concatenate([np.zeros_like(plane[:1]), plane[:-1]])
        check(np.array_equal(zres.cpu().numpy(), ZIGZAG[plane - ref]),
              f"token_delta_encode != the codec's residual ({what})")
        check(torch.equal(zres, token_delta_encode_ref(video)),
              f"token_delta_encode != plain version ({what})")
        check_decoded(what, frames, video, zres, torch.zeros_like(video[0]))
    # group 0's stack in two calls, the second from the first's last frame
    what, _, g0_video, g0_zres, frames = max(results,
                                             key=lambda r: r[2].numel())
    check(tuple(g0_video.shape) == PLANE_STACK,
          f"group 0's plane stack is {tuple(g0_video.shape)}, not "
          f"PLANE_STACK")
    split = PLANE_STACK[0] // 2 + 1
    head = td_ops.token_delta_decode_frames(torch.zeros_like(g0_video[0]),
                                            g0_zres[:split])
    tail = td_ops.token_delta_decode_frames(head[-1], g0_zres[split:])
    check(torch.equal(torch.cat([head, tail]), frames),
          f"{what} decoded in two calls split at frame {split} != one call")
    log(f"[kernel] token_delta on the prefix's 240p planes: "
        + ", ".join(f"{name} {tuple(ch[0].shape)} x {len(ch)} channels"
                    for name, ch in planes)
        + f"; launches {launches} (one encode and one decode per plane "
        f"stack); bit-equal to the plain versions, the chained one-frame "
        f"decode and the codec's ZIGZAG residuals, every frame rebuilt; "
        f"{what} split at frame {split} equals one call")
    # a bandwidth-sized stack and an unaligned one, checked the same way,
    # and decoded once more by the one-frame op (the kernel at F = 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    stacks = {}
    for shape in (BIG_STACK, ODD_STACK):
        video = torch.randint(0, 256, shape, generator=g, device=dev,
                              dtype=torch.uint8)
        e0, d0 = td_ops.encode_launches, td_ops.decode_launches
        zres = td_ops.token_delta_encode(video)
        check(torch.equal(zres, token_delta_encode_ref(video)),
              f"token_delta_encode != plain version at {shape}")
        zero = torch.zeros_like(video[0])
        frames = td_ops.token_delta_decode_frames(zero, zres)
        check_decoded(f"{shape}", frames, video, zres, zero)
        prev = zero
        for f in range(shape[0]):
            prev = td_ops.token_delta_decode_frame(prev, zres[f])
            check(torch.equal(prev, frames[f]),
                  f"token_delta_decode_frame at {shape}, frame {f}")
        check((td_ops.encode_launches - e0, td_ops.decode_launches - d0)
              == (1, 1 + shape[0]), f"token_delta launches at {shape}")
        stacks[shape] = (video, zres)
    log(f"[kernel] token_delta at {BIG_STACK} and {ODD_STACK}: one encode "
        f"and one stack decode each, bit-equal to the plain versions; the "
        f"chained one-frame decode bit-equal too, every frame rebuilt")
    big, big_z = stacks[BIG_STACK]
    # encode (row C): the path's largest plane stack and the big stack
    timed = []
    for v in (g0_video, big):
        ms = graph_ms(lambda: td_ops.token_delta_encode(v))
        eager_ms = time_ms(lambda: td_ops.token_delta_encode(v))
        plain_ms = graph_ms(lambda: token_delta_encode_ref(v))
        n_bytes = 2 * v.numel()
        b_ms, b_by = delta_bound(n_bytes)
        log(f"[kernel] token_delta_encode {tuple(v.shape)}: device "
            f"{ms * 1e3:.2f} us/launch (eager call {eager_ms * 1e3:.2f} us; "
            f"plain version {plain_ms * 1e3:.2f} us; library: none (no "
            f"single PyTorch call); bound {b_ms * 1e3:.3f} us by {b_by}, "
            f"{n_bytes} bytes)")
        timed.append((ms, plain_ms, b_ms, b_by))
    src = "src/repro_torch/kernels/token_delta/token_delta.cu"
    tpu = "src/repro/kernels/token_delta/token_delta.py:"
    ms, plain_ms, b_ms, b_by = timed[0]
    rows = [dict(name="token_delta_encode", route="cuda", source=src,
                 replaces=tpu + "39", max_abs_err=0.0, ms=ms,
                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=None)]
    # decode (row D): the path's two stack shapes and the big stack, each
    # beside the chained one-frame decode of the same stack in one graph
    chunk_z = next(r[3] for r in results if r[0].startswith("chunk"))
    unzz = torch.as_tensor(UNZIGZAG, device=dev)
    dec = {}
    for z in (chunk_z, g0_zres, big_z):
        shape, F = tuple(z.shape), z.shape[0]
        zero = torch.zeros_like(z[0])
        iters = 100 if z.numel() < 1 << 24 else 10

        def stack():
            td_ops.token_delta_decode_frames(zero, z)

        def chained():
            prev = zero
            for f in range(F):
                prev = td_ops.token_delta_decode_frame(prev, z[f])
        ms, eager_ms = graph_ms(stack, iters), time_ms(stack, iters)
        chain_ms, chain_eager = graph_ms(chained, iters), time_ms(chained,
                                                                 iters)
        plain_ms = graph_ms(lambda: token_delta_decode_frames_ref(zero, z),
                            max(iters // 10, 3))
        # the reference frame read once, each residual byte read once and
        # each output byte written once
        n_bytes = (2 * F + 1) * z[0].numel()
        b_ms, b_by = delta_bound(n_bytes)
        chain_b, _ = delta_bound(3 * z.numel())
        res = unzz[z.long()]
        lib = torch.cumsum(res, 0, dtype=torch.uint8)
        check(torch.equal(lib, td_ops.token_delta_decode_frames(zero, z)),
              f"uint8 cumsum != the stack decode at {shape}")
        lib_ms = graph_ms(lambda: torch.cumsum(res, 0, dtype=torch.uint8),
                          iters)
        log(f"[kernel] token_delta_decode_frames {shape}: device "
            f"{ms * 1e3:.2f} us/launch (eager call {eager_ms * 1e3:.2f} us)")
        log(f"[kernel] token_delta_decode_frame chained over {shape}: "
            f"{F} launches in one graph {chain_ms * 1e3:.2f} us (eager "
            f"{chain_eager * 1e3:.2f} us)")
        log(f"[kernel] token_delta_decode_frames_ref {shape}: plain version "
            f"{plain_ms * 1e3:.2f} us")
        log(f"[kernel] token_delta decode {shape} bound: {b_ms * 1e3:.3f} us "
            f"by {b_by}, {n_bytes} bytes ((2F + 1) H W); the chained "
            f"pattern's own bound, 3 F H W bytes, {chain_b * 1e3:.3f} us")
        log(f"[kernel] torch.cumsum(uint8) over residuals unzigzagged "
            f"beforehand {shape}: {lib_ms * 1e3:.2f} us (context only: not "
            f"the same function, the unzigzag lookup left out)")
        dec[shape] = dict(ms=ms, plain_ms=plain_ms, b_ms=b_ms, b_by=b_by,
                          chain_ms=chain_ms)
    # the path decodes each channel's chunk stack and group 0's stack once
    n_ch = len(planes[0][1])
    loss = sum(n_ch * (d["ms"] - d["b_ms"]) for s, d in dec.items()
               if s != BIG_STACK)
    chain_loss = sum(n_ch * (d["chain_ms"] - d["b_ms"])
                     for s, d in dec.items() if s != BIG_STACK)
    log(f"[kernel] token_delta decode on the path: "
        f"{launches['token_delta_decode_frames']} launches; loss over the "
        f"bound {loss:.4f} ms per run (chained one-frame decode of the same "
        f"stacks, one launch per frame: {chain_loss:.4f} ms)")
    d = dec[PLANE_STACK]
    rows.append(dict(name="token_delta_decode_frames", route="cuda",
                     source=src, replaces=tpu + "66", max_abs_err=0.0,
                     ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["b_ms"],
                     bound_by=d["b_by"], library_ms=None))
    del stacks, big, big_z
    torch.cuda.empty_cache()
    return rows, launches


# -- phase 4: the main path ---------------------------------------------------

def expected_restores(cfg, man) -> int:
    """kv_restore launches for one fetch of ``man``: one per chunk (of
    both kinds) that holds at least one frame."""
    lay = IntraLayout(cfg.num_kv_heads, cfg.head_dim, *man.layout)
    codec = KVCodec(cfg.num_kv_heads, cfg.head_dim, lay)
    return sum(codec.frame_count(man.blobs[(r.chunk_id, RESOLUTION)]) > 0
               for r in man.refs)


def check_restored_pages(eng, cfg, man, rid, frames: dict) -> None:
    """The pages ``rid`` holds for ``man``'s tokens against the codec's
    dequantized frames, bit for bit.  ``frames`` keeps those frames per
    (prefix, chunk id), so a prefix checked again is not decoded again."""
    rows = torch.as_tensor(eng.cache.slots_for(rid, np.arange(man.n_tokens)),
                           device=eng.device).long()
    for r in man.refs:
        key = (man.prefix, r.chunk_id)
        if key not in frames:
            frames[key] = decode_chunk_tokens(
                man, r.chunk_id, RESOLUTION, cfg.num_kv_heads, cfg.head_dim)
        deq = frames[key]
        pages = eng.cache.k_pages if r.kind == "k" else eng.cache.v_pages
        for li, layer in enumerate(r.layers):
            got = eng.cache.layer_rows(pages, layer)[
                rows[r.token_start:r.token_end]].cpu().numpy()
            check(np.array_equal(got, deq[:, li]),
                  f"rid {rid}: restored {r.chunk_id} layer {layer} differs "
                  f"from the codec's dequantized frames")


def profile_step(fn, what: str = "one decode step"):
    """``fn()`` under torch.profiler: device busy share and the operators
    that take the most device and host time.  Returns what ``fn()``
    returned."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        busy = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # launches whose kernel has a device record: the busy time is a lower
    # bound when the profiler lost some (see kernel_counts)
    events = prof.profiler.kineto_results.events()
    launch_ids = {e.correlation_id() for e in events
                  if e.device_type() != torch.autograd.DeviceType.CUDA
                  and "Launch" in e.name()}
    recorded = len({e.correlation_id() for e in events
                    if e.device_type() == torch.autograd.DeviceType.CUDA}
                   & launch_ids)
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        (kernels if on_device else ops).append(
            (dev_us if on_device else e.self_cpu_time_total, e.count, e.key))
    busy_ms = sum(k[0] for k in kernels) / 1e3
    n_launch = sum(k[1] for k in kernels)
    log(f"[profile] {what}: wall {wall_ms:.2f} ms (profiled), "
        f"{n_launch} kernels, device busy {busy_ms:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; {recorded} of "
        f"{len(launch_ids)} launches have a device record")
    for us, count, key in sorted(kernels, reverse=True)[:6]:
        log(f"[profile]   kernel  device {us / 1e3:8.3f} ms  x{count:<5d} "
            f"{key[:60]}")
    for us, count, key in sorted(ops, reverse=True)[:6]:
        log(f"[profile]   host op host   {us / 1e3:8.3f} ms  x{count:<5d} "
            f"{key[:60]}")
    return busy


def counted() -> dict:
    """The serving kernels' launch counts: ``rans_decode`` one launch per
    restored chunk on the card, as ``kv_restore``."""
    return {"kv_restore": kv_ops.launches,
            "paged_attention": pa_ops.launches,
            "rans_decode": rans_ops.launches}


def reset_counts() -> None:
    kv_ops.launches = pa_ops.launches = rans_ops.launches = 0


def serve(dev, cfg, params, store, key, prompts, plain, reuse: bool):
    eng = LiveEngine(params, cfg, store, n_pages=N_PAGES, device=dev)
    reqs = [eng.submit(p, reuse_prefix=key if reuse else None,
                       reuse_tokens=PREFIX_TOKENS if reuse else 0,
                       max_new_tokens=NEW_TOKENS) for p in prompts]
    reqs.append(eng.submit(plain, max_new_tokens=NEW_TOKENS))
    return eng, reqs


def main_path(dev, cfg, params, store, man, prefix, prompts, plain,
              frames, tag: str = "main"):
    key = prefix_key(prefix)
    eng, reqs = serve(dev, cfg, params, store, key, prompts, plain, True)
    reuse_reqs = reqs[:2]
    step_ms, profiled, checked = [], False, False
    torch.cuda.synchronize()
    reset_counts()
    busy = True
    while busy:
        prefilled = all(r.t_first_token is not None for r in reqs)
        if prefilled and not profiled and len(step_ms) == 4:
            busy, profiled = profile_step(eng.step), True
            continue
        t0 = time.perf_counter()
        busy = eng.step()
        torch.cuda.synchronize()
        if prefilled:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if not checked and all(r.t_first_token is not None
                               for r in reuse_reqs):
            # pages still held: compare them before the sequences finish
            n = counted()
            for r in reuse_reqs:
                check_restored_pages(eng, cfg, man, r.rid, frames)
            checked = n == counted()
            check(checked, "page check launched a kernel")
    launches = counted()
    check(len(eng.finished) == len(reqs), "not every request finished")
    for r in reqs:
        out = eng.outputs[r.rid]
        check(len(out) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in out),
              f"rid {r.rid}: bad output {out}")
    decode_steps = len({t for r in reqs for t in r.token_times[1:]})
    want = {"kv_restore": 2 * expected_restores(cfg, man),
            "paged_attention": cfg.num_layers * decode_steps,
            "rans_decode": 2 * expected_restores(cfg, man)}
    log(f"[{tag}] launches {launches}, expected {want} "
        f"({decode_steps} decode steps)")
    check(launches == want, "launch counts differ from the main path's")
    # EngineStats counts each token once per restored chunk: k and v of
    # every layer group, for each of the two reuse requests
    check(eng.stats.restored_tokens
          == 2 * 2 * len(man.layer_groups) * PREFIX_TOKENS,
          f"restored {eng.stats.restored_tokens} tokens")
    for r in reqs:
        fetch = "" if r.fetch_done is None else \
            f", fetch+decode+restore {r.fetch_done - r.fetch_started:.3f} s"
        log(f"[{tag}] rid {r.rid} ({'reuse' if r.reuse_tokens else 'plain'})"
            f": TTFT {r.ttft:.3f} s{fetch}")
    log(f"[{tag}] decode step ({len(reqs)} sequences, {cfg.num_layers} "
        f"layers): median {statistics.median(step_ms):.2f} ms over "
        f"{len(step_ms)} steps; "
        f"fetched {eng.stats.fetched_bytes} bytes, restore buffer high "
        f"water {eng.stats.restore_buffer_high_water} bytes")
    outputs = {r.rid: eng.outputs[r.rid] for r in reqs}
    del eng
    torch.cuda.empty_cache()
    # not asserted: int8 KV at full width with random weights may flip an
    # argmax against a full prefill of the same prompt
    full, full_reqs = serve(dev, cfg, params, store, key, prompts, plain,
                            False)
    full.run()
    for r in full_reqs[:2]:
        same = full.outputs[r.rid] == outputs[r.rid]
        log(f"[{tag}] rid {r.rid}: reuse generation "
            f"{'matches' if same else 'differs from'}"
            f" a full prefill of the same prompt")
    del full
    torch.cuda.empty_cache()
    return launches, outputs


# -- phase 5: the virtual-clock fetch pipeline --------------------------------

def virtual_net(man):
    """The modeled link and decode table of phase 5: the table's chunk
    size is the store's mean blob, so the pool scales its latency by
    about 1, and the link moves a mean blob in ``VIRTUAL_DECODE_S``."""
    sizes = [len(man.blobs[(r.chunk_id, RESOLUTION)]) for r in man.refs]
    mean_bytes = float(np.mean(sizes))
    table = DecodeTable(name="host-rans", n_decoders=1,
                        latency={RESOLUTION: (VIRTUAL_DECODE_S,)},
                        penalty={RESOLUTION: 0.0},
                        chunk_size_mb={RESOLUTION: mean_bytes / 1e6})
    gbps = mean_bytes * 8 / VIRTUAL_DECODE_S / 1e9
    return BandwidthTrace.constant(gbps), table, gbps, mean_bytes


def virtual_path(dev, cfg, params, store, man, prefix, prompts, plain,
                 wall_outputs, frames):
    key = prefix_key(prefix)
    trace, table, gbps, mean_bytes = virtual_net(man)
    log(f"[virtual] link {gbps:.6f} Gbps constant; decode table "
        f"'{table.name}': 1 decoder, {VIRTUAL_DECODE_S * 1e3:.1f} ms per "
        f"{RESOLUTION} chunk of {mean_bytes / 1e6:.6f} MB (the mean of "
        f"{len(man.refs)} blobs); compute on the cost model's h20 "
        f"(modeled times, not the card's)")
    want_kv = expected_restores(cfg, man)
    ttft, outputs = {}, {}
    for mode in ("sync", "async"):
        eng = LiveEngine(params, cfg, store, n_pages=N_PAGES, device=dev,
                         fetch_mode=mode, bandwidth=trace,
                         decode_table=table)
        reuse = eng.submit(prompts[0], reuse_prefix=key,
                           reuse_tokens=PREFIX_TOKENS,
                           max_new_tokens=NEW_TOKENS)
        other = eng.submit(plain, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        checked, steps, t_check = False, 0, 0.0
        while eng.step():
            steps += 1
            check(steps < 100_000, f"{mode}: the engine does not finish")
            if not checked and reuse.t_first_token is not None:
                # the check decodes every chunk again on the host: its
                # time is taken out of the run's wall time
                t1 = time.perf_counter()
                n = counted()
                check_restored_pages(eng, cfg, man, reuse.rid, frames)
                check(n == counted(), "page check launched a kernel")
                checked = True
                t_check = time.perf_counter() - t1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - t_check
        launches = counted()
        reqs = (reuse, other)
        decode_steps = len({t for r in reqs for t in r.token_times[1:]})
        want = {"kv_restore": want_kv,
                "paged_attention": cfg.num_layers * decode_steps,
                "rans_decode": want_kv}
        log(f"[virtual] {mode}: launches {launches}, expected {want} "
            f"({decode_steps} decode steps)")
        check(checked, f"{mode}: the restored pages were not checked")
        check(launches == want, f"{mode}: launch counts differ")
        check(len(eng.finished) == 2, f"{mode}: not every request finished")
        for r, prompt_rid in ((reuse, 0), (other, 2)):
            check(eng.outputs[r.rid] == wall_outputs[prompt_rid],
                  f"{mode} rid {r.rid}: tokens {eng.outputs[r.rid]} differ "
                  f"from the wall-clock phase's {wall_outputs[prompt_rid]}")
        fetch = reuse.fetch_done - reuse.fetch_started
        log(f"[virtual] {mode}: modeled TTFT reuse {reuse.ttft:.4f} s "
            f"(modeled fetch+decode+restore {fetch:.4f} s, early admitted "
            f"{reuse.early_admitted}), plain {other.ttft:.4f} s; "
            f"prefill_stall_time {eng.stats.prefill_stall_time:.4f} s "
            f"(modeled); wall {wall:.2f} s over {steps + 1} steps (page "
            f"check {t_check:.2f} s not counted); "
            f"fetched {eng.stats.fetched_bytes} bytes")
        ttft[mode] = (reuse.ttft, other.ttft)
        outputs[mode] = (eng.outputs[reuse.rid], eng.outputs[other.rid])
        del eng
        torch.cuda.empty_cache()
    check(ttft["async"][0] < ttft["sync"][0],
          f"async TTFT {ttft['async'][0]} not below sync {ttft['sync'][0]}")
    check(ttft["async"][1] < ttft["async"][0],
          "the plain request waited for the fetch in async mode")
    log(f"[virtual] async/sync modeled reuse TTFT "
        f"{ttft['async'][0] / ttft['sync'][0]:.4f}; tokens equal across "
        f"modes and to phase 4's")
    return ttft, outputs


# -- phase 5d: a mesh-sharded engine ------------------------------------------

def sharded_path(dev, cfg, params, store, man, prefix, prompts, plain,
                 wall_outputs, virtual, frames):
    """Phase 5's requests through a ``LiveEngine`` laid out on a (1, 1)
    ``DeviceMesh`` with ``mesh_shards=MESH_SHARDS``: each fetch runs as
    per-shard flows through the one controller.  Returns the launches of
    both modes and the ``paged_attention`` launches by decode batch
    size."""
    key = prefix_key(prefix)
    trace, table, _, _ = virtual_net(man)
    want_kv = expected_restores(cfg, man)
    n_groups = len(man.layer_groups)
    want_subs = min(MESH_SHARDS, n_groups)
    # an engine and its controller's hooks form a cycle: collect the
    # earlier phases' engines before the peak is taken
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mesh = make_debug_mesh((1, 1), device=dev)
    log(f"[sharded] mesh {mesh}; backend "
        f"{torch.distributed.get_backend()}; mesh_shards {MESH_SHARDS} over "
        f"{n_groups} layer groups; {want_kv} chunks a fetch")
    launches = dict.fromkeys(counted(), 0)
    by_batch: dict = {}
    split = engine_mod.split_plan_shards
    decode_paged = paged_model.decode_paged
    try:
        for mode in ("sync", "async"):
            splits, batches = [], []

            def split_recorded(plan, n):
                splits.append(split(plan, n))
                return splits[-1]

            def decode_recorded(p, c, tokens, positions, cache, seq_ids):
                batches.append(len(seq_ids))
                return decode_paged(p, c, tokens, positions, cache, seq_ids)

            eng = LiveEngine(params, cfg, store, n_pages=N_PAGES, device=dev,
                             fetch_mode=mode, bandwidth=trace,
                             decode_table=table, mesh=mesh,
                             mesh_shards=MESH_SHARDS)
            check(eng.n_shards == MESH_SHARDS,
                  f"{mode}: {eng.n_shards} shards, not {MESH_SHARDS}")
            views = (eng.cache.k_dtensor, eng.cache.v_dtensor)
            for view, pages in zip(views, (eng.cache.k_pages,
                                           eng.cache.v_pages)):
                check(view.placements == (Replicate(), Shard(3)),
                      f"{mode}: pages placed {view.placements}")
                check(view.to_local().data_ptr() == pages.data_ptr()
                      and view.to_local().stride() == pages.stride(),
                      f"{mode}: the DTensor view does not share the pages")
            reuse = eng.submit(prompts[0], reuse_prefix=key,
                               reuse_tokens=PREFIX_TOKENS,
                               max_new_tokens=NEW_TOKENS)
            other = eng.submit(plain, max_new_tokens=NEW_TOKENS)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            checked, steps, t_check = False, 0, 0.0
            with mock.patch.object(engine_mod, "split_plan_shards",
                                   split_recorded), \
                    mock.patch.object(paged_model, "decode_paged",
                                      decode_recorded):
                while eng.step():
                    steps += 1
                    check(steps < 100_000,
                          f"{mode}: the engine does not finish")
                    if not checked and reuse.t_first_token is not None:
                        t1 = time.perf_counter()
                        n = counted()
                        check_restored_pages(eng, cfg, man, reuse.rid, frames)
                        check(n == counted(), "page check launched a kernel")
                        checked = True
                        t_check = time.perf_counter() - t1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0 - t_check
            got = counted()
            decode_steps = len(batches)
            want = {"kv_restore": want_kv,
                    "paged_attention": cfg.num_layers * decode_steps,
                    "rans_decode": want_kv}
            sizes = [len(sp.chunks) for subs in splits for sp in subs]
            log(f"[sharded] {mode}: launches {got}, expected {want} "
                f"({decode_steps} decode steps, batch sizes "
                f"{dict(sorted((b, batches.count(b)) for b in set(batches)))}"
                f"); subplans of {sizes} chunks")
            check(checked, f"{mode}: the restored pages were not checked")
            check(got == want, f"{mode}: launch counts differ")
            check(len(splits) == 1 and len(sizes) == want_subs
                  and all(sizes) and sum(sizes) == len(man.refs),
                  f"{mode}: subplans of {sizes} chunks, not {want_subs} "
                  f"non-empty ones over {len(man.refs)}")
            check(not eng._sharded, f"{mode}: a sharded fetch is still "
                  f"tracked")
            check(len(eng.finished) == 2, f"{mode}: not every request "
                  f"finished")
            for r, prompt_rid, ref in ((reuse, 0, virtual[1][mode][0]),
                                       (other, 2, virtual[1][mode][1])):
                out = eng.outputs[r.rid]
                check(out == ref == wall_outputs[prompt_rid],
                      f"{mode} rid {r.rid}: tokens {out} differ from phase "
                      f"5's {ref} or phase 4's {wall_outputs[prompt_rid]}")
            base = virtual[0][mode]
            log(f"[sharded] {mode}: modeled TTFT reuse {reuse.ttft:.4f} s "
                f"(phase 5, unsharded: {base[0]:.4f} s), plain "
                f"{other.ttft:.4f} s ({base[1]:.4f} s); modeled "
                f"fetch+decode+restore "
                f"{reuse.fetch_done - reuse.fetch_started:.4f} s; "
                f"prefill_stall_time {eng.stats.prefill_stall_time:.4f} s; "
                f"wall {wall:.2f} s over {steps + 1} steps (page check "
                f"{t_check:.2f} s not counted); tokens equal to phase 5's "
                f"and phase 4's")
            for name, n in got.items():
                launches[name] += n
            for b in batches:
                by_batch[b] = by_batch.get(b, 0) + cfg.num_layers
            del eng, views
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
    peak = torch.cuda.max_memory_allocated()
    log(f"[sharded] phase wall {time.perf_counter() - t_phase:.2f} s (page "
        f"checks included); peak memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB; {held / 2**30:.2f} GiB held when the "
        f"phase started)")
    return launches, by_batch


# -- phase 5b: the storage tier, host staging and prefetch ------------------

def storage_script(dev, cfg, params, prefix, prompt, kv_k, kv_v, man, *,
                   new_tokens: int, n_pages: int, frames: dict, log_fn=None):
    """The storage tier's four hit kinds on one engine, one request at a
    time, each alone in the engine (so each is a batch of one):

    - R1 asks for all of ``prefix`` (the first tokens of ``prompt``) when
      only its first half, the ancestor, is registered: a partial hit;
    - the ancestor's node fails; R2 asks for the ancestor: a miss, served
      by a plain prefill, whose first token writes the ancestor back (on
      the other node); then a plain request for the same prompt;
    - the whole prefix is registered from ``man`` (no second encode), its
      parent the ancestor; R3 asks for the ancestor: a full hit on the
      other node, which heats its child, so the prefetcher stages it;
    - R4 asks for the whole prefix: a host hit.

    For each request the launch counts are set to 0 just before and read
    just after; on the card ``kv_restore`` must equal the fetched chunks
    and ``paged_attention`` the layers times the decode steps.  Every
    fetch's restored pages are checked against the codec's frames while
    the request holds them.  Returns the requests, their tokens, the
    counts, the cluster's and prefetcher's event logs and the ancestor's
    entry (its encoded manifest)."""
    n_anc = len(prefix) // 2
    cluster = StorageCluster([StorageNode("n0"), StorageNode("n1")],
                             replication=1, heal="manual")
    t0 = time.perf_counter()
    anc = cluster.register_prefix(prefix[:n_anc], kv_k[:n_anc],
                                  kv_v[:n_anc],
                                  tokens_per_chunk=TOKENS_PER_CHUNK,
                                  resolutions=(RESOLUTION,))
    if log_fn is not None:
        log_fn(f"ancestor: {n_anc} tokens encoded on the host in "
               f"{time.perf_counter() - t0:.2f} s, "
               f"{anc.stored_bytes} bytes in {len(anc.manifest.refs)} "
               f"chunks")
    # R1's and R2's lookups heat the ancestor twice; at the default
    # threshold of 2 the prefetcher would stage it before R3, and R3 would
    # be a host hit.  At 3, R3's full hit is the ancestor's third lookup
    # and its child's first heat of 3: both are staged after R3
    prefetch = PrefetchManager(cluster, HostStagingTier(None),
                               transport="sync", heat_threshold=3.0,
                               continuation_boost=3.0)
    eng = LiveEngine(params, cfg, cluster, n_pages=n_pages, device=dev,
                     prefetch=prefetch)
    on_card = eng.device.type == "cuda"
    out = {}

    def fetched(r):
        """The manifest a fetch restored: whatever hit it was, it covers
        the prompt's first ``reuse_tokens`` tokens."""
        return cluster.catalog[prefix_key(prompt[:r.reuse_tokens])].manifest

    def serve_one(name, reuse_tokens, want_hit):
        r = eng.submit(prompt, reuse_prefix="by-tokens" if reuse_tokens
                       else None, reuse_tokens=reuse_tokens,
                       max_new_tokens=new_tokens)
        if on_card:
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        checked, t_check = False, 0.0
        while eng.step():
            if not checked and r.t_first_token is not None:
                t1 = time.perf_counter()
                if r.needs_fetch:
                    n = counted()
                    check_restored_pages(eng, cfg, fetched(r), r.rid,
                                         frames)
                    check(n == counted(), "page check launched a kernel")
                checked = True
                t_check = time.perf_counter() - t1
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - t_check
        launches = counted()
        chunks = expected_restores(cfg, fetched(r)) \
            if on_card and r.needs_fetch else 0
        want = {"kv_restore": chunks,
                "paged_attention": cfg.num_layers * (new_tokens - 1)
                if on_card else 0,
                "rans_decode": chunks}
        check(r.storage_hit == want_hit,
              f"{name}: hit {r.storage_hit}, expected {want_hit}")
        check(checked and len(eng.outputs[r.rid]) == new_tokens
              and all(0 <= t < cfg.vocab_size for t in eng.outputs[r.rid]),
              f"{name}: bad output {eng.outputs[r.rid]}")
        check(launches == want, f"{name}: launches {launches}, "
              f"expected {want}")
        if log_fn is not None:
            fetch = ("" if r.fetch_done is None else
                     f", fetch+decode+restore "
                     f"{r.fetch_done - r.fetch_started:.3f} s")
            log_fn(f"{name}: {r.storage_hit} hit on "
                   f"{r.storage_node or '-'}, reuse {r.reuse_tokens} "
                   f"tokens; TTFT {r.ttft:.3f} s{fetch}; wall {wall:.2f} s "
                   f"(page check {t_check:.2f} s not counted); launches "
                   f"{launches}, expected {want}")
        out[name] = dict(req=r, tokens=eng.outputs[r.rid],
                         launches=launches)
        return r

    r1 = serve_one("R1", len(prefix), "partial")
    check(r1.reuse_tokens == n_anc and r1.requested_reuse_tokens
          == len(prefix), f"R1 reuses {r1.reuse_tokens} tokens")
    failed = r1.storage_node
    eng.fail_node(failed)
    serve_one("R2", n_anc, "miss")
    serve_one("plain", 0, None)
    check(out["R2"]["tokens"] == out["plain"]["tokens"],
          f"R2 (miss) {out['R2']['tokens']} != a plain prefill's "
          f"{out['plain']['tokens']}")
    cluster.register(StoredPrefix.from_manifest(
        man, raw_kv_bytes=int(kv_k.nbytes + kv_v.nbytes), parent=anc.key,
        token_ids=np.asarray(prefix)), eng.now())
    r3 = serve_one("R3", n_anc, "full")
    check(r3.storage_node not in (None, failed),
          f"R3 served by {r3.storage_node}, the failed node is {failed}")
    serve_one("R4", len(prefix), "host")
    check(("host_hit", man.prefix) in prefetch.events,
          f"no host hit for the prefix in {prefetch.events}")
    return out, list(cluster.events), list(prefetch.events), anc


def storage_path(dev, cfg, params, man, prefix, prompts, kv_k, kv_v,
                 wall_outputs, frames):
    t0 = time.perf_counter()
    out, events, pf_events, anc = storage_script(
        dev, cfg, params, prefix, prompts[0], kv_k, kv_v, man,
        new_tokens=NEW_TOKENS, n_pages=N_PAGES, frames=frames,
        log_fn=lambda s: log(f"[storage] {s}"))
    wall = time.perf_counter() - t0
    check(out["R4"]["tokens"] == wall_outputs[0],
          f"R4 (host) {out['R4']['tokens']} != phase 4's "
          f"{wall_outputs[0]} for the same prompt")
    launches = {k: sum(o["launches"][k] for o in out.values())
                for k in counted()}
    log(f"[storage] cluster events {events}")
    log(f"[storage] prefetch events {pf_events}")
    log(f"[storage] kv_restore launches per request "
        + " + ".join(str(out[n]["launches"]["kv_restore"])
                     for n in ("R1", "R2", "R3", "R4"))
        + f" = {launches['kv_restore']} (the fetched chunks); R2's tokens "
        f"equal a plain prefill's, R4's phase 4's; phase wall time "
        f"{wall:.2f} s (encode of the ancestor and page checks included)")
    return launches, anc


def fair_script(dev, cfg, params, prefix, prompts, kv_k, kv_v):
    """Two users on the virtual clock behind a FairScheduler: alice
    (premium) and bob (free) each send two reuse requests through a
    two-node StorageCluster over a modeled link, one fetch at a time.
    Returns the tokens, token times and the fairness and cluster logs."""
    cluster = StorageCluster([StorageNode("n0"), StorageNode("n1")],
                             replication=1)
    cluster.register_prefix(prefix, kv_k, kv_v,
                            tokens_per_chunk=TOKENS_PER_CHUNK,
                            resolutions=(RESOLUTION,))
    fair = FairScheduler(max_inflight=1)
    table = DecodeTable(name="fair-toy", n_decoders=1,
                        latency={RESOLUTION: (0.06,)},
                        penalty={RESOLUTION: 0.0},
                        chunk_size_mb={RESOLUTION: 0.002})
    eng = LiveEngine(params, cfg, cluster, device=dev, max_running=8,
                     fetch_mode="sync",
                     bandwidth=BandwidthTrace.constant(0.0006),
                     decode_table=table, use_table_sizes=True,
                     adaptive=False, resolutions=(RESOLUTION,),
                     cost=EngineCostModel(cfg, CHIPS["h20"], 2),
                     fairness=fair)
    reqs = [eng.submit(prompts[i % 2], reuse_prefix="by-tokens",
                       reuse_tokens=len(prefix), max_new_tokens=4,
                       user=user, slo_tier=tier)
            for i, (user, tier) in enumerate(
                [("bob", "free"), ("bob", "free"), ("alice", "premium"),
                 ("alice", "premium")])]
    eng.run()
    check(all(len(eng.outputs[r.rid]) == 4 for r in reqs),
          "a fair-scheduled request did not finish")
    return ([eng.outputs[r.rid] for r in reqs],
            [list(r.token_times) for r in reqs], list(fair.events),
            list(cluster.events))


# -- phase 5c: a fleet of engines behind the prefix-affinity router ---------

def instrument(fleet):
    """Per node, the kernel launches made inside its engine's ``step``,
    ``dispatch_fetch`` and ``local_restore`` (none of them calls
    another); per request, the wall time of its ``dispatch_fetch`` or
    ``local_restore``, ending in a device sync."""
    per = [dict.fromkeys(counted(), 0) for _ in fleet.engines]
    dispatch_wall = {}
    for k, eng in enumerate(fleet.engines):
        for name in ("step", "dispatch_fetch", "local_restore"):
            def wrapped(*a, _fn=getattr(eng, name), _k=k, _name=name):
                n0 = counted()
                t0 = time.perf_counter()
                out = _fn(*a)
                if _name != "step":
                    torch.cuda.synchronize()
                    dispatch_wall[a[0].rid] = time.perf_counter() - t0
                for op, n in counted().items():
                    per[_k][op] += n - n0[op]
                return out
            setattr(eng, name, wrapped)
    return per, dispatch_wall


def fleet_path(dev, cfg, params, man, raw_kv_bytes, anc, prefix, prompts,
               plain, wall_outputs, frames):
    """``LiveFleet`` of ``FLEET_NODES`` full-width engines on the virtual
    clock (sync fetches) over one copy of the weights, behind the
    affinity router, one ``FairScheduler(max_inflight=1)`` and a two-node
    cluster (replication 1, manual heal) that holds phase 5b's encoded
    256-token ancestor A and the set-up's 512-token prefix P, P's parent
    A.  The router sends the chain to one node, whose local KV holds
    ``PREFIX_TOKENS`` tokens, so caching P evicts A.  Three plain
    requests go to the idle nodes.  Dispatch order (by the fair
    scheduler, lagging user first): A fetched (full hit); A's storage
    node fails; A restored locally; P fetched for bob (full hit on the
    other node; carol, charged for her plain requests' decode work, now
    lags bob); P restored locally for carol; A asked once more, neither
    local nor stored: a miss and a plain prefill, held against one of
    A's prompt alone.  Every restore's pages are checked against the
    codec's frames at the request's first token; the same script runs
    on the host through the analytic ``FleetSimulator`` and must give
    the same router, fairness and cluster logs; every decode step's
    shape must be one of ``FLEET_BATCHES``.  Returns the launches and
    ``paged_attention``'s launches by decode step shape."""
    n_anc = anc.manifest.n_tokens
    suffix = prompts[0][PREFIX_TOKENS:]
    prompt_of = {"A": np.concatenate([prefix[:n_anc], suffix]),
                 "P": prompts[0], None: plain}
    # (user, tier, prefix), submitted in this order; rid = index
    script = [("alice", "premium", "A"), ("bob", "standard", "A"),
              ("carol", "free", "P"), ("bob", "standard", "P"),
              ("alice", "premium", "A"), ("carol", "free", None),
              ("carol", "free", None), ("carol", "free", None)]
    want_hit = ["full", "local", "local", "full", "miss", None, None, None]
    cluster = StorageCluster([StorageNode("n0"), StorageNode("n1")],
                             replication=1, heal="manual")
    cluster.register(StoredPrefix.from_manifest(
        anc.manifest, raw_kv_bytes=anc.raw_kv_bytes,
        token_ids=np.asarray(prefix[:n_anc])))
    cluster.register(StoredPrefix.from_manifest(
        man, raw_kv_bytes=raw_kv_bytes, parent=anc.key,
        token_ids=np.asarray(prefix)))
    key_of = {"A": anc.key, "P": man.prefix, None: None}
    doomed = cluster.primary_node(anc.key).node_id
    check(cluster.primary_node(man.prefix).node_id != doomed,
          "A and P share a storage node: P's fetch would miss")
    churn = [(1, "fail", doomed)]
    trace, table, _, _ = virtual_net(man)
    reqs = [Request(rid=i, arrival=0.0, prompt_len=len(prompt_of[name]),
                    reuse_tokens=len(prompt_of[name]) - len(suffix)
                    if name else 0, prefix=key_of[name],
                    max_new_tokens=FLEET_NEW_TOKENS, user=user,
                    slo_tier=tier)
            for i, (user, tier, name) in enumerate(script)]
    # the chain's node holds its five requests' rows at once at most; each
    # plain node one request's
    need = [table_width(r.prompt_len, r.max_new_tokens) for r in reqs]
    n_pages = max(sum(n for n, (_, _, name) in zip(need, script) if name),
                  max(need))

    t_check = [0.0]
    wall_first = {}
    holder = {}

    def on_token(req, tok, t):
        if len(req.token_times) != 1:
            return
        t1 = time.perf_counter()
        wall_first[req.rid] = t1 - holder["t0"] - t_check[0]
        if req.storage_hit in ("full", "local"):
            fleet = holder["fleet"]
            eng = fleet.engines[fleet.placement[req.rid]]
            n = counted()
            check_restored_pages(eng, cfg, cluster.catalog[req.prefix]
                                 .manifest, req.rid, frames)
            check(n == counted(), "page check launched a kernel")
            holder["checked"].append(req.rid)
        t_check[0] += time.perf_counter() - t1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fair = FairScheduler(max_inflight=1)
    fleet = LiveFleet(
        params, cfg, cluster, n_nodes=FLEET_NODES, bandwidth=trace,
        policy="affinity", fairness=fair, local_kv_tokens=PREFIX_TOKENS,
        churn_at_dispatch=churn, device=dev,
        engine_kw=dict(n_pages=n_pages, max_running=16,
                       decode_table=table, use_table_sizes=True,
                       adaptive=False, resolution=RESOLUTION,
                       resolutions=(RESOLUTION,),
                       cost=EngineCostModel(cfg, CHIPS["h20"], 2),
                       on_token=on_token))
    holder.update(fleet=fleet, checked=[])
    check(all(e.params is params for e in fleet.engines),
          "the engines do not share one copy of the weights")
    per_node, dispatch_wall = instrument(fleet)
    for r, (user, tier, name) in zip(reqs, script):
        fleet.submit(prompt_of[name], prefix_key=r.prefix,
                     reuse_tokens=r.reuse_tokens,
                     max_new_tokens=FLEET_NEW_TOKENS, user=user,
                     slo_tier=tier)
    # every decode step's shape, as the engines hand it to the model
    batches = []
    decode_paged = paged_model.decode_paged

    def recorded(params, cfg, tokens, positions, cache, seq_ids):
        batches.append((tuple(sorted((positions + 1).tolist())),
                        cache.block_table_array(seq_ids).shape[1]))
        return decode_paged(params, cfg, tokens, positions, cache, seq_ids)

    reset_counts()
    holder["t0"] = time.perf_counter()
    with mock.patch.object(paged_model, "decode_paged", recorded):
        fleet.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - holder["t0"] - t_check[0]
    launches = counted()
    peak = torch.cuda.max_memory_allocated()
    done = {r.rid: r for e in fleet.engines for r in e.finished}
    check(sorted(done) == list(range(len(script))),
          f"finished {sorted(done)} of {len(script)} requests")
    out = {rid: fleet.engines[fleet.placement[rid]].outputs[rid]
           for rid in done}
    hits = [done[i].storage_hit for i in range(len(script))]
    check(hits == want_hit, f"hit kinds {hits}, expected {want_hit}")
    check(("fail", "", doomed) in cluster.events,
          f"{doomed} did not fail: {cluster.events}")
    check(len({fleet.placement[i] for i, (_, _, name) in enumerate(script)
               if name}) == 1, f"the chain is split: {fleet.placement}")
    restored = [i for i, h in enumerate(hits) if h in ("full", "local")]
    check(sorted(holder["checked"]) == restored,
          f"pages checked for {holder['checked']}, restored {restored}")

    # tokens: P's prompt and the plain prompt are phase 4's; a local hit
    # gives the full hit's tokens for the same prompt
    for i, (_, _, name) in enumerate(script):
        if name in ("P", None):
            ref = wall_outputs[0 if name == "P" else 2][:FLEET_NEW_TOKENS]
            check(out[i] == ref, f"fleet rid {i} ({name}): {out[i]} != "
                  f"phase 4's {ref}")
        check(len(out[i]) == FLEET_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in out[i]),
              f"fleet rid {i}: bad output {out[i]}")
    check(out[1] == out[0] and out[2] == out[3],
          f"a local hit's tokens differ from the full hit's: {out}")
    # A's miss is a plain prefill: held against one of A's prompt alone
    miss = want_hit.index("miss")
    alone = LiveEngine(params, cfg, KVStore(), device=dev,
                       n_pages=table_width(FLEET_A, FLEET_NEW_TOKENS))
    r = alone.submit(prompt_of["A"], max_new_tokens=FLEET_NEW_TOKENS)
    alone.run()
    check(alone.outputs[r.rid] == out[miss],
          f"fleet rid {miss} (A's miss) {out[miss]} != a plain prefill's "
          f"{alone.outputs[r.rid]}")
    del alone

    # launches: one kv_restore per restored chunk, one paged_attention
    # per layer and decode step, node by node
    want_nodes = []
    for k, eng in enumerate(fleet.engines):
        mine = [r for r in done.values() if fleet.placement[r.rid] == k]
        steps = len({t for r in mine for t in r.token_times[1:]})
        chunks = sum(expected_restores(
            cfg, cluster.catalog[r.prefix].manifest) for r in mine
            if r.storage_hit in ("full", "local"))
        want_nodes.append({"kv_restore": chunks,
                           "paged_attention": cfg.num_layers * steps,
                           "rans_decode": chunks})
    want = {n: sum(w[n] for w in want_nodes) for n in launches}
    log(f"[fleet] launches {launches}, expected {want}; per node "
        f"{per_node}, expected {want_nodes}")
    check(per_node == want_nodes and launches == want,
          "fleet launch counts differ from the script's")
    # paged_attention's launches by the shape of their decode step
    shapes = {b: cfg.num_layers * batches.count(b) for b in set(batches)}
    check(sum(shapes.values()) == launches["paged_attention"],
          f"decode steps {batches} do not make "
          f"{launches['paged_attention']} launches")

    # the same script on the host: the analytic FleetSimulator over
    # synthetic twins of the two prefixes
    sim_cluster = StorageCluster([StorageNode("n0"), StorageNode("n1")],
                                 replication=1, heal="manual")
    for key in (anc.key, man.prefix):
        src = cluster.catalog[key]
        sim_cluster.register(StoredPrefix(
            key=key, n_tokens=src.n_tokens,
            bytes_by_resolution={RESOLUTION: src.stored_bytes},
            raw_kv_bytes=src.raw_kv_bytes, parent=src.parent), 0.0)
    fair_s = FairScheduler(max_inflight=1)
    spec = MethodSpec("kvfetcher", ratios={"stream": 8.0}, adaptive=False,
                      fixed_resolution=RESOLUTION, uses_decode_pool=True,
                      use_table_sizes=True, pipelined=False,
                      layerwise_admission=False, resolutions=(RESOLUTION,))
    t1 = time.perf_counter()
    sim = FleetSimulator(cfg, spec, n_nodes=FLEET_NODES, bandwidth=trace,
                         storage=sim_cluster, table=table, fairness=fair_s,
                         policy="affinity", local_kv_tokens=PREFIX_TOKENS,
                         churn_at_dispatch=churn, chunk_tokens=16,
                         max_running=16)
    res = sim.run([Request(rid=r.rid, arrival=0.0, prompt_len=r.prompt_len,
                           reuse_tokens=r.reuse_tokens, prefix=r.prefix,
                           max_new_tokens=r.max_new_tokens, user=r.user,
                           slo_tier=r.slo_tier) for r in reqs],
                  max_new_tokens=FLEET_NEW_TOKENS)
    t_sim = time.perf_counter() - t1

    def lookups(c):
        return [e for e in c.events if e[0] in FLEET_LOOKUP_KINDS]

    check(fleet.router.events == res.router_events
          and fleet.placement == res.placements,
          f"router: card {fleet.router.events} != host "
          f"{res.router_events}")
    check(fair.events == res.fairness_events,
          f"fairness: card {fair.events} != host {res.fairness_events}")
    check(lookups(cluster) == lookups(sim_cluster),
          f"cluster: card {lookups(cluster)} != host "
          f"{lookups(sim_cluster)}")
    check(hits.count("local") == res.local_hits,
          f"local hits: card {hits.count('local')}, host "
          f"{res.local_hits}")
    sim_ttft = {r.rid: r.ttft for r in res.requests}
    for i, (user, _, name) in enumerate(script):
        r = done[i]
        what = {"local": "local restore", "miss": "lookup"}.get(
            r.storage_hit, "fetch")
        service = ("" if i not in dispatch_wall else
                   f", its {what} {dispatch_wall[i]:.3f} s wall")
        log(f"[fleet] rid {i} {user} {name or 'plain'} on "
            f"s{fleet.placement[i]}: {r.storage_hit or 'no fetch'}"
            f"{' from ' + r.storage_node if r.storage_node else ''}; "
            f"modeled TTFT {r.ttft:.4f} s (host simulator "
            f"{sim_ttft[i]:.4f} s); wall TTFT {wall_first[i]:.3f} s from "
            f"the run's start{service}")
    log(f"[fleet] dispatches per node {fleet.dispatches_by_node}; router "
        f"{fleet.router.events}")
    log(f"[fleet] cluster events {cluster.events}")
    log(f"[fleet] {len(fair.events)} fairness events, "
        f"{len(lookups(cluster))} cluster lookup events, "
        f"{res.local_hits} local hits: equal to the host FleetSimulator's "
        f"(run in {t_sim:.2f} s); tokens equal to phase 4's and the local "
        f"hits' to the full hits', the miss's to a plain prefill's; pages "
        f"of {len(restored)} restores bit-equal")
    log(f"[fleet] paged_attention launches by decode step (contexts, "
        f"block-table width): {sorted(shapes.items())}")
    log(f"[fleet] {FLEET_NODES} nodes x {n_pages} pages; peak memory "
        f"allocated {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held "
        f"when the phase started); phase wall {wall:.2f} s (page checks "
        f"{t_check[0]:.2f} s not counted)")
    del fleet
    torch.cuda.empty_cache()
    check(set(shapes) == set(FLEET_BATCHES),
          f"the fleet's decode steps {sorted(shapes)} differ from "
          f"FLEET_BATCHES {sorted(FLEET_BATCHES)}")
    return launches, shapes


# -- phase 6: agreement with the plain versions at a small size ---------------

def to_device(tree, dev):
    """A copy of a parameter tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def small_engine(dev, arch: str, num_layers: int = 2):
    """A reduced engine on the CPU and on the card from the same weights:
    two reuse requests of a 48-token prefix and one plain request must
    generate the same tokens.  Returns (cfg, CPU params, card params,
    prefix, prompts, donor K/V)."""
    cfg = reduce_config(get_config(arch), num_layers=num_layers)
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    rng = np.random.default_rng(SEED + 1)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, 48, 2, 8)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    dev_params = to_device(params, dev)
    outs = []
    for d, p in (("cpu", params), (dev, dev_params)):
        store = KVStore()
        store.register_prefix(prefix, kv_k, kv_v,
                              tokens_per_chunk=TOKENS_PER_CHUNK,
                              resolutions=(RESOLUTION,))
        eng = LiveEngine(p, cfg, store, device=d)
        for pr in prompts:
            eng.submit(pr, reuse_prefix=prefix_key(prefix), reuse_tokens=48,
                       max_new_tokens=6)
        eng.submit(prompts[0], max_new_tokens=6)
        eng.run()
        outs.append([eng.outputs[i] for i in range(3)])
    check(outs[0] == outs[1], f"{cfg.name}: card {outs[1]} != cpu {outs[0]}")
    log(f"[small] reduced {arch} ({num_layers} layers) engine on the card == "
        f"on the CPU: {outs[1]}")
    return cfg, params, dev_params, prefix, prompts, kv_k, kv_v


def small_reference(dev) -> None:
    cfg, params, dev_params, prefix, prompts, kv_k, kv_v = small_engine(
        dev, "lwm-7b")
    # the storage script and two users behind a FairScheduler on the
    # virtual clock, on the CPU and on the card
    man = encode_prefix(kv_k, kv_v, prefix=prefix_key(prefix),
                        tokens_per_chunk=TOKENS_PER_CHUNK,
                        resolutions=(RESOLUTION,))
    runs = []
    for d, p in (("cpu", params), (dev, dev_params)):
        out, events, pf_events, _ = storage_script(
            d, cfg, p, prefix, prompts[0], kv_k, kv_v, man, new_tokens=6,
            n_pages=N_PAGES, frames={})
        runs.append(dict(
            tokens={n: o["tokens"] for n, o in out.items()},
            hits={n: (o["req"].storage_hit, o["req"].storage_node,
                      o["req"].reuse_tokens) for n, o in out.items()},
            events=events, prefetch=pf_events,
            fair=fair_script(d, cfg, p, prefix, prompts, kv_k, kv_v)))
    for what in runs[0]:
        check(runs[0][what] == runs[1][what],
              f"small storage tier, {what}: card {runs[1][what]} != cpu "
              f"{runs[0][what]}")
    log(f"[small] reduced storage script on the card == on the CPU: hits "
        f"{runs[1]['hits']}, tokens {runs[1]['tokens']}, "
        f"{len(runs[1]['events'])} cluster events, "
        f"{len(runs[1]['prefetch'])} prefetch events equal")
    log(f"[small] reduced FairScheduler run (virtual clock, 2 users) on the "
        f"card == on the CPU: tokens {runs[1]['fair'][0]}, "
        f"{len(runs[1]['fair'][2])} fairness events and "
        f"{len(runs[1]['fair'][3])} cluster events equal")


# -- phase 7: Mamba2 at full width ---------------------------------------------

def mamba_set_up(dev):
    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    torch.cuda.synchronize()
    log(f"[mamba] mamba2-2.7b full width, {n_params(params) / 1e9:.3f} B "
        f"fp32 params, init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, MAMBA_PREFIX,
                                           2, SUFFIX_TOKENS)
    return cfg, params, prefix, prompts


# -- phase 8: ssd_scan against its plain version ------------------------------

def scan_inputs(dev, b, s, nh, hd, G, S, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def f(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    # a_log = dt * A with dt = softplus(.) ~ 0.7 and A = -1 at init
    return (f(b, s, nh, hd), -torch.nn.functional.softplus(f(b, s, nh)),
            f(b, s, G, S), f(b, s, G, S))


def scan_bound(b, s, nh, hd, G, S, Q):
    """(ms, "bytes" | "operations", fp32 SIMT ms) for one scan: inputs
    read once and outputs written once; the products the function needs
    (``ssd_ops.scan_flops``, the op's FLOP formula).  The kernel forms
    them in 3xTF32 on the tensor cores, three TF32 products each; the
    third value is the same work in fp32 outside them."""
    n_bytes = 4 * (2 * b * s * nh * hd + b * s * nh + 2 * b * s * G * S
                   + b * nh * hd * S)
    n_flops = ssd_ops.scan_flops(b, s, nh, hd, G, S, Q)
    ms, by = bound(n_bytes, 3 * n_flops, TF32_FLOPS_PER_S)
    return ms, by, n_flops / FP32_FLOPS_PER_S * 1e3


def ssd_scan_phase(dev, cfg, n_kernels: int):
    nh, hd, G, S = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                    cfg.ssm_state)
    err = 0.0
    timed = None
    for s in (MAMBA_PREFIX, MAMBA_PREFIX + SUFFIX_TOKENS, 40):
        args = scan_inputs(dev, 1, s, nh, hd, G, S, s)
        want_y, want_st = ssd_scan_ref(*args, chunk=SCAN_CHUNK)
        y, st = ssd_ops.ssd_scan(*args, chunk=SCAN_CHUNK)
        torch.cuda.synchronize()
        for got, want, what in ((y, want_y, "y"), (st, want_st, "state")):
            e = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(e <= SCAN_TOL * scale,
                  f"ssd_scan s={s}: {what} off by {e} (largest {scale})")
            err = max(err, e)
            log(f"[kernel] ssd_scan s={s} nh={nh} hd={hd} G={G} S={S} "
                f"chunk={SCAN_CHUNK}: {what} max_abs_err {e:.3g} of "
                f"largest {scale:.3g}")
        if s == MAMBA_PREFIX:
            timed = args
    ms = graph_ms(lambda: ssd_ops.ssd_scan(*timed, chunk=SCAN_CHUNK),
                  iters=20)
    eager_ms = time_ms(lambda: ssd_ops.ssd_scan(*timed, chunk=SCAN_CHUNK),
                       iters=20)
    plain_ms = graph_ms(lambda: ssd_scan_ref(*timed, chunk=SCAN_CHUNK),
                        iters=5)
    b_ms, b_by, simt_ms = scan_bound(1, MAMBA_PREFIX, nh, hd, G, S,
                                     SCAN_CHUNK)
    piece, slices = ssd_ops.plan(SCAN_CHUNK, hd)
    log(f"[kernel] ssd_scan s={MAMBA_PREFIX}: {nh * slices} blocks ({slices} "
        f"hd slices per head, pieces of {piece}), {n_kernels} CUDA kernels "
        f"per op call; device {ms * 1e3:.2f} "
        f"us/call (eager call {eager_ms * 1e3:.2f} us; plain version "
        f"{plain_ms * 1e3:.2f} us; no single PyTorch call computes it; "
        f"bound {b_ms * 1e3:.2f} us by {b_by} in 3xTF32 at 495 TFLOP/s, "
        f"fp32 SIMT {simt_ms * 1e3:.2f} us)")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan/ssd_scan.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# -- phase 8b: ssd_scan's backward against its plain version -----------------

def scan_bwd_bound(b, s, nh, hd, G, S, Q):
    """(ms, "bytes" | "operations", fp32 SIMT ms) of one backward: x, a,
    B, C, dy and dstate read once, dx, da, dB and dC written once; the
    products the chunked gradient needs (``ssd_ops.scan_bwd_flops``, the
    op's FLOP formula).  The kernel forms them in 3xTF32 on the tensor
    cores, three TF32 products each; the third value is the same work in
    fp32 outside them."""
    n_bytes = 4 * (3 * b * s * nh * hd + 2 * b * s * nh + 4 * b * s * G * S
                   + b * nh * hd * S)
    n_flops = ssd_ops.scan_bwd_flops(b, s, nh, hd, G, S, Q)
    ms, by = bound(n_bytes, 3 * n_flops, TF32_FLOPS_PER_S)
    return ms, by, n_flops / FP32_FLOPS_PER_S * 1e3


def ssd_scan_bwd_phase(dev, cfg, n_kernels: int, fwd_ms: float):
    """The backward kernel against ``ssd_scan_bwd_ref`` and against
    ``torch.autograd`` through ``ssd_scan_ref``, on the card, from a seeded
    dy and a non-zero dstate: each gradient within 2e-4 of its largest
    magnitude; timed in a CUDA graph beside its bound and the forward."""
    nh, hd, G, S = (cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_ngroups,
                    cfg.ssm_state)
    err = 0.0
    timed = None
    for s in (MAMBA_PREFIX, 40, MAMBA_PREFIX + SUFFIX_TOKENS):
        args = scan_inputs(dev, 1, s, nh, hd, G, S, s + 7)
        g = torch.Generator(device=dev).manual_seed(s + 8)
        dy = torch.randn(1, s, nh, hd, device=dev, generator=g)
        dstate = torch.randn(1, nh, hd, S, device=dev, generator=g)
        got = ssd_ops.ssd_scan_bwd(*args, dy, dstate, chunk=SCAN_CHUNK)
        want = ssd_scan_bwd_ref(*args, dy, dstate, chunk=SCAN_CHUNK)
        req = [t.clone().requires_grad_() for t in args]
        auto = torch.autograd.grad(ssd_scan_ref(*req, chunk=SCAN_CHUNK), req,
                                   (dy, dstate))
        torch.cuda.synchronize()
        for name, a, plain, ag in zip(("dxdt", "da_log", "dBm", "dCm"), got,
                                      want, auto):
            errs = []
            for what, ref in (("plain", plain), ("autograd", ag)):
                e = (a - ref).abs().max().item()
                scale = ref.abs().max().item()
                check(a.shape == ref.shape and e <= SCAN_TOL * scale,
                      f"ssd_scan_bwd s={s}: {name} off the {what} version "
                      f"by {e} (largest {scale})")
                errs.append(f"{e:.3g} vs {what}")
            err = max(err, (a - plain).abs().max().item())
            log(f"[kernel] ssd_scan_bwd s={s} nh={nh} hd={hd} G={G} S={S} "
                f"chunk={SCAN_CHUNK}: {name} max_abs_err {', '.join(errs)} "
                f"of largest {plain.abs().max().item():.3g}")
        if s == MAMBA_PREFIX:
            timed = (*args, dy, dstate)
        del got, want, auto, req
    ms = graph_ms(lambda: ssd_ops.ssd_scan_bwd(*timed, chunk=SCAN_CHUNK),
                  iters=20)
    eager_ms = time_ms(lambda: ssd_ops.ssd_scan_bwd(*timed, chunk=SCAN_CHUNK),
                       iters=20)
    plain_ms = graph_ms(lambda: ssd_scan_bwd_ref(*timed, chunk=SCAN_CHUNK),
                        iters=5)
    b_ms, b_by, simt_ms = scan_bwd_bound(1, MAMBA_PREFIX, nh, hd, G, S,
                                         SCAN_CHUNK)
    piece, ks, cs = ssd_ops.bwd_plan(SCAN_CHUNK, hd, S)
    log(f"[kernel] ssd_scan_bwd s={MAMBA_PREFIX}: {n_kernels} CUDA kernels "
        f"per op call (C.B^T, sweeps on {2 * nh * ks * cs} blocks, pieces of "
        f"{piece} on {nh * -(-MAMBA_PREFIX // piece)} blocks, two sums); "
        f"device {ms * 1e3:.2f} us/call (eager call {eager_ms * 1e3:.2f} "
        f"us; the forward {fwd_ms * 1e3:.2f} us; plain version "
        f"{plain_ms * 1e3:.2f} us; no single PyTorch call computes it; "
        f"bound {b_ms * 1e3:.2f} us by {b_by} in 3xTF32 at 495 TFLOP/s, "
        f"fp32 SIMT {simt_ms * 1e3:.2f} us)")
    return dict(name="ssd_scan_bwd", route="cuda",
                source="src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
                replaces="src/repro/models/ssm.py:99",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# -- phase 9: the Mamba2 path -------------------------------------------------

def generate(params, cfg, logits, cache, pos: int, n: int):
    """Greedy: the first token from ``logits`` [b, V], then ``n - 1``
    decode steps.  Returns (tokens [b, n], the host clock when the first
    token was on the card, per-step ms)."""
    toks = [logits.argmax(-1)]
    torch.cuda.synchronize()
    t_first = time.perf_counter()
    step_ms = []
    for i in range(n - 1):
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(params, cfg, toks[-1], pos + i, cache)
        toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(toks, 1).cpu().numpy(), t_first, step_ms


def check_rebuilt(rebuilt, back, cfg) -> None:
    got = tf.snapshot_states(rebuilt, cfg)
    check(sorted(got) == sorted(back), "rebuilt cache has other tensors")
    for name, arr in back.items():
        for r in range(got[name].shape[1]):
            check(np.array_equal(got[name][:, r:r + 1], arr),
                  f"rebuilt {name} row {r} differs from the decoded array")


def mamba_path(dev, cfg, params, prefix, prompts):
    L = cfg.num_layers
    suffix = torch.as_tensor(np.stack([p[MAMBA_PREFIX:] for p in prompts]),
                             device=dev)
    plain = torch.as_tensor(prompts[0][None], device=dev)
    torch.cuda.synchronize()
    ssd_ops.launches = 0
    # donor
    t0 = time.perf_counter()
    donor_logits, donor_cache = tf.prefill(
        params, cfg, tokens=torch.as_tensor(prefix[None], device=dev))
    torch.cuda.synchronize()
    t_donor = time.perf_counter() - t0
    t0 = time.perf_counter()
    states = tf.snapshot_states(donor_cache, cfg)
    t_copy = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = encode_state_snapshot(states)
    t_enc = time.perf_counter() - t0
    n_vals = sum(v.size for v in states.values())
    log(f"[mamba] donor prefill {MAMBA_PREFIX} tokens {t_donor:.3f} s; "
        f"state to host {t_copy:.3f} s; host encode {t_enc:.2f} s: "
        f"{len(blob)} bytes for {n_vals} int8 values "
        f"({', '.join(f'{k} {v.shape}' for k, v in states.items())})")
    # two reuse requests, batched, from the one snapshot
    t0 = time.perf_counter()
    back = decode_state_snapshot(blob)
    t_dec = time.perf_counter() - t0
    rebuilt = tf.cache_from_snapshot(back, cfg, dev, batch=2)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0 - t_dec
    cache = rebuilt
    first_step = None
    for k in range(SUFFIX_TOKENS):
        logits, cache = tf.decode_step(params, cfg, suffix[:, k],
                                       MAMBA_PREFIX + k, cache)
        if k == 0:
            first_step = logits
    reuse_out, t_first, reuse_ms = generate(
        params, cfg, logits, cache, MAMBA_PREFIX + SUFFIX_TOKENS, NEW_TOKENS)
    reuse_ttft = t_first - t0
    # one plain request
    t0 = time.perf_counter()
    plain_logits, plain_cache = tf.prefill(params, cfg, tokens=plain)
    plain_out, t_first, plain_ms = generate(
        params, cfg, plain_logits[:, -1], plain_cache, plain.shape[1],
        NEW_TOKENS)
    plain_ttft = t_first - t0
    launches = ssd_ops.launches
    log(f"[mamba] ssd_scan launches {launches}, expected {2 * L} "
        f"(2 prefills x {L} layers)")
    check(launches == 2 * L, "ssd_scan launches differ from the path's")
    check_rebuilt(rebuilt, back, cfg)
    for out in (reuse_out, plain_out):
        check(out.shape[1] == NEW_TOKENS and (out >= 0).all()
              and (out < cfg.vocab_size).all(), f"bad output {out}")
    log(f"[mamba] reuse TTFT {reuse_ttft:.3f} s (snapshot decode "
        f"{t_dec:.3f} s + upload {t_up:.3f} s + {SUFFIX_TOKENS} suffix "
        f"steps at b=2 + first token); plain TTFT {plain_ttft:.3f} s "
        f"(prefill {plain.shape[1]} tokens + first token)")
    log(f"[mamba] decode step ({L} layers): median "
        f"{statistics.median(reuse_ms):.2f} ms at b=2 over "
        f"{len(reuse_ms)} steps, {statistics.median(plain_ms):.2f} ms at "
        f"b=1 over {len(plain_ms)} steps")
    # the JAX test's measure: one decode step from the rebuilt cache
    # against the same step from the donor's exact cache; reported, not
    # gated (one int8 scale spans all 64 layers' states)
    exact, _ = tf.decode_step(params, cfg, suffix[:1, 0], MAMBA_PREFIX,
                              donor_cache)
    got = first_step[:1]
    e = (got - exact).abs().max().item()
    scale = exact.abs().max().item()
    log(f"[mamba] reuse vs exact cache, first suffix step: max |logit "
        f"diff| {e:.4g}, {e / scale:.4g} of the largest |logit| "
        f"{scale:.4g}; argmax "
        f"{'agrees' if int(got.argmax()) == int(exact.argmax()) else 'differs'}"
        f"; generation {'matches' if (reuse_out[0] == plain_out[0]).all() else 'differs from'}"
        f" the plain request's")
    # the kernel's prefill against the plain version's, on the card
    with mock.patch.object(ssm_mod, "ssd_scan", ssd_scan_ref):
        ref_logits, ref_cache = tf.prefill(
            params, cfg, tokens=torch.as_tensor(prefix[None], device=dev))
    torch.cuda.synchronize()
    check(ssd_ops.launches == launches, "the plain prefill used the kernel")
    e = (donor_logits - ref_logits).abs().max().item()
    scale = ref_logits.abs().max().item()
    st_err = max((a["state"] - r["state"]).abs().max().item()
                 for a, r in zip(donor_cache, ref_cache))
    log(f"[mamba] prefill logits, kernel vs plain version on the card: "
        f"max abs err {e:.4g} of largest {scale:.4g}; final states max abs "
        f"err {st_err:.4g}")
    check(e <= LOGIT_TOL * scale, "kernel prefill logits off")
    profile_step(lambda: tf.prefill(
        params, cfg, tokens=torch.as_tensor(prefix[None], device=dev)),
        f"one {MAMBA_PREFIX}-token prefill")
    profile_step(lambda: tf.decode_step(params, cfg, suffix[:, 0],
                                        MAMBA_PREFIX, rebuilt),
                 "one decode step at b=2")
    return launches


# -- phase 10: the snapshot path at a small size, card against CPU ------------

def small_mamba_reference(dev) -> None:
    cfg = reduce_config(get_config("mamba2-2.7b"))
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    rng = np.random.default_rng(SEED + 1)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, 100, 2, 8)
    dev_params = to_device(params, dev)
    outs = []
    for d, p in (("cpu", params), (dev, dev_params)):
        before = ssd_ops.launches
        _, cache = tf.prefill(p, cfg, tokens=torch.as_tensor(prefix[None],
                                                             device=d))
        check(ssd_ops.launches - before == (0 if d == "cpu"
                                             else cfg.num_layers),
              f"small mamba2 on {d}: wrong ssd_scan launch count")
        blob = encode_state_snapshot(tf.snapshot_states(cache, cfg))
        cache = tf.cache_from_snapshot(decode_state_snapshot(blob), cfg, d,
                                       batch=2)
        suffix = torch.as_tensor(np.stack([q[100:] for q in prompts]),
                                 device=d)
        for k in range(suffix.shape[1]):
            logits, cache = tf.decode_step(p, cfg, suffix[:, k], 100 + k,
                                           cache)
        toks = [logits.argmax(-1)]
        for i in range(5):
            logits, cache = tf.decode_step(p, cfg, toks[-1], 108 + i, cache)
            toks.append(logits.argmax(-1))
        outs.append(torch.stack(toks, 1).cpu().tolist())
    check(outs[0] == outs[1], f"card {outs[1]} != cpu {outs[0]}")
    log(f"[small] reduced mamba2 snapshot path on the card == on the CPU: "
        f"{outs[1]}")


# -- phase 10b: mamba2-2.7b trained at full width -----------------------------

def check_all_changed(params, before) -> None:
    """Every leaf of ``params`` differs from its copy in ``before``."""
    for (path, now), old in zip(flatten(params), before):
        check(not torch.equal(now, old.to(now.device)),
              f"{path} did not change")


def train_path(dev) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` (AdamW with a cosine
    schedule, remat) on mamba2-2.7b at full width, b 1, s 2048, from
    ``init_state`` and ``data.pipeline.batches``.  Each step's counts are
    set to 0 just before it and read just after: ``ssd_scan`` 2 per layer
    (the forward and its recompute), its backward 1 per layer.  Returns
    the launches of all steps; frees every training tensor."""
    cfg = get_config("mamba2-2.7b")
    L = cfg.num_layers
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, warmup=1, total=TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(
        SEED + 7), dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(state.params))
    check(n == MAMBA_PARAMS, f"{n} parameters, not {MAMBA_PARAMS}")
    log(f"[train] mamba2-2.7b full width: {n} fp32 parameters, AdamW state "
        f"{4 * n * 3 / 2**30:.2f} GiB with the parameters (+ "
        f"{4 * n / 2**30:.2f} GiB of gradients in a step); init "
        f"{time.perf_counter() - t0:.2f} s")
    before = [t.to("cpu", copy=True) for t in leaves(state.params)]
    step_fn = make_train_step(cfg, opt, remat=True)
    data = batches(cfg, DataConfig(batch_size=1, seq_len=MAMBA_PREFIX,
                                   seed=SEED))
    step_ms, total = [], {"ssd_scan": 0, "ssd_scan_bwd": 0}
    batch = None
    for i in range(TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(data).items()}
        torch.cuda.synchronize()
        ssd_ops.launches = ssd_ops.bwd_launches = 0
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        fwd, bwd = ssd_ops.launches, ssd_ops.bwd_launches
        total["ssd_scan"] += fwd
        total["ssd_scan_bwd"] += bwd
        log(f"[train] step {i}: loss {loss:.5f} grad_norm {gnorm:.5f} "
            f"lr {float(opt.lr(state.opt.count)):.3g}; {step_ms[-1]:.1f} ms; "
            f"ssd_scan {fwd} launches, backward {bwd}")
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"step {i}: loss {loss}, grad_norm {gnorm}")
        check(fwd == 2 * L and bwd == L,
              f"step {i}: ssd_scan {fwd} and backward {bwd} launches, the "
              f"path's {2 * L} and {L}")
        if i == 0:
            check(abs(loss - np.log(cfg.vocab_size)) <= 1.0,
                  f"step 0 loss {loss}, not within 1 of ln "
                  f"{cfg.vocab_size} = {np.log(cfg.vocab_size):.3f}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(int(state.step) == TRAIN_STEPS, "steps not counted")
    check_all_changed(state.params, before)
    del before
    med = statistics.median(step_ms[1:])
    flops = model_flops(cfg, InputShape("train", MAMBA_PREFIX, 1, "train"))
    log(f"[train] {TRAIN_STEPS} steps, every parameter leaf changed; step "
        f"time median {med:.1f} ms over steps 1-{TRAIN_STEPS - 1} (step 0 "
        f"{step_ms[0]:.1f} ms); {MAMBA_PREFIX / med * 1e3:.1f} tokens/s; "
        f"model FLOPs {flops / 1e12:.2f} TFLOP per step, MFU "
        f"{flops / (med / 1e3) / FP32_FLOPS_PER_S:.4f} of 67 TFLOP/s fp32 "
        f"(TF32 off); peak memory {peak:.2f} GiB")
    profile_step(lambda: step_fn(state, batch), "one train step")
    del state, step_fn, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    log(f"[train] freed: {left:.3f} GiB still allocated")
    check(left < 1.0, f"{left:.2f} GiB still allocated after training")
    return total


# -- phases 11-13: deepseek-moe-16b at full width ----------------------------

def moe_path(dev, cfg, params, store, man, prefix, prompts, plain, frames):
    """Phase 13: phase 4's requests through deepseek-moe-16b's engine,
    then the plain request's first-token logits against
    ``transformer.prefill`` of the same prompt on the card (both route
    the 528 tokens as one group).  Returns the kernels' launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = []
    collect = paged_model.prefill_collect_kv

    def recorded(params_, cfg_, tokens):
        logits, kvs = collect(params_, cfg_, tokens)
        served.append((tokens[0].cpu().numpy(), logits[0]))
        return logits, kvs

    moe_ops.launches = 0
    t_spans = time.monotonic()
    with mock.patch.object(paged_model, "prefill_collect_kv", recorded):
        launches, _ = main_path(dev, cfg, params, store, man, prefix,
                                prompts, plain, frames, tag="moe")
    torch.cuda.synchronize()
    # every MoE layer call of both engines of main_path went through the
    # grouped kernels, and a decode step of b sequences chose at most
    # b x experts_per_token experts a layer
    spans = tracing.TRACER.spans("moe", t_spans)
    launches["moe_experts"] = moe_ops.launches
    check(spans is not None and moe_ops.launches == len(spans) > 0,
          f"moe_experts: {moe_ops.launches} kernel calls, "
          f"{None if spans is None else len(spans)} MoE layer calls")
    check(all(s.counts["experts"] <= min(cfg.num_experts,
                                         s.counts["choices"])
              for s in spans), "a moe span counts more experts than choices")
    decode = {}
    for s in spans:
        if s.parent is not None and s.parent.name == "decode step":
            b = s.counts["tokens"]
            decode[b] = max(decode.get(b, 0), s.counts["experts"])
    log(f"[moe] {len(spans)} MoE layer calls through moe_experts; most "
        f"experts a decode step's layer call chose, by batch: {decode} "
        f"(top {cfg.experts_per_token} a token)")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = next(lg for toks, lg in served if np.array_equal(toks, plain))
    # transformer.prefill routes through capacity groups: at a capacity
    # factor of E no choice is dropped, which is the engine's dropless
    # routing
    no_drop = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts)
    ref, _ = tf.prefill(params, no_drop,
                        tokens=torch.as_tensor(plain[None], device=dev))
    ref = ref[0, 0]
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    top2 = torch.topk(ref, 2).values
    log(f"[moe] plain request's first-token logits ({len(plain)} tokens, "
        f"no choice dropped): engine vs transformer.prefill max abs err "
        f"{err:.4g} of the largest |logit| {scale:.4g}; argmax "
        f"{'agrees' if int(got.argmax()) == int(ref.argmax()) else 'differs'}"
        f" (top-2 margin {(top2[0] - top2[1]).item():.4g})")
    check(err <= LOGIT_TOL * scale,
          "the engine's prefill logits differ from transformer.prefill's")
    log(f"[moe] phase wall {wall:.2f} s (page checks included); peak memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB) beside "
        f"{n_params(params) * 4 / 2**30:.2f} GiB of weights")
    return launches


#: (case, rows, depth, widths) of ``dense_3xtf32_phase``: yi-9b's products
#: at the benchmark's median prompt (q/k/v in one launch, o, SwiGLU wi, MLP
#: wo), lwm-7b's at the path's 512-token donor prefill, deepseek-moe-16b's
#: at a 1,024-token document (q/k/v, its shared experts' wi and wo, layer
#: 0's MLP wo)
DENSE_CASES = (("yi-9b q/k/v", 1020, 4096, (4096, 512, 512)),
               ("yi-9b o", 1020, 4096, (4096,)),
               ("yi-9b wi", 1020, 4096, (22016,)),
               ("yi-9b mlp wo", 1020, 11008, (4096,)),
               ("lwm-7b q/k/v", 512, 4096, (4096,) * 3),
               ("lwm-7b wi", 512, 4096, (22016,)),
               ("lwm-7b mlp wo", 512, 11008, (4096,)),
               ("deepseek-moe-16b q/k/v", 1024, 2048, (2048,) * 3),
               ("deepseek-moe-16b shared wi", 1024, 2048, (5632,)),
               ("deepseek-moe-16b shared wo", 1024, 2816, (2048,)),
               ("deepseek-moe-16b mlp wo", 1024, 10944, (2048,)))


def dense_bound(M: int, K: int, widths) -> tuple:
    """(bound ms, what bounds it, the fp32 SIMT bound ms) of one launch:
    x, the weights and the outputs moved once; 2 M K N operations, three
    times over in 3xTF32 at 495 TFLOP/s, once at 67 in fp32."""
    N = sum(widths)
    n_bytes = 4.0 * (M * K + K * N + M * N)
    ms, by = bound(n_bytes, 3 * 2.0 * M * K * N, TF32_FLOPS_PER_S)
    return ms, by, bound(n_bytes, 2.0 * M * K * N)[0]


def rel_err(y: torch.Tensor, ref: torch.Tensor) -> float:
    """relative Frobenius norm of y - ref, ref in fp64"""
    return ((y.double() - ref).norm() / ref.norm()).item()


def dense_3xtf32_phase(dev, n_kernels: int) -> dict:
    """``dense_3xtf32`` against fp64 and its plain version (torch.matmul
    in fp32) at each ``DENSE_CASES`` shape, timed.  Returns the kernel
    row: the sums over yi-9b's four products (a layer of the benchmark's
    median plain prefill)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    times, worst = {}, 0.0
    for case, M, K, widths in DENSE_CASES:
        x = torch.randn(M, K, device=dev, generator=g)
        ws = [torch.randn(K, N, device=dev, generator=g) * K ** -0.5
              for N in widths]
        got = dense_ops.dense_3xtf32(x, ws)
        plain = dense_ref(x, ws)
        torch.cuda.synchronize()
        err = err32 = 0.0
        for y, p, w in zip(got, plain, ws):
            ref = x.double() @ w.double()
            err, err32 = max(err, rel_err(y, ref)), max(err32,
                                                         rel_err(p, ref))
        check(err <= 2 * err32, f"dense_3xtf32 {case}: error {err:.3g} "
              f"against fp64, torch.matmul's {err32:.3g}")
        worst = max(worst, err)
        ms = graph_ms(lambda: dense_ops.dense_3xtf32(x, ws), iters=20)
        plain_ms = graph_ms(lambda: dense_ref(x, ws), iters=20)
        b_ms, b_by, simt_ms = dense_bound(M, K, widths)
        times[case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, simt_ms=simt_ms)
        tflops = 2.0 * M * K * sum(widths) / ms / 1e9
        log(f"[kernel] dense_3xtf32 {case} (M {M}, K {K}, N {widths}): "
            f"error {err:.3g} against fp64, torch.matmul's {err32:.3g}; "
            f"{n_kernels} CUDA kernels per call; device {ms * 1e3:.2f} "
            f"us/call ({tflops:.1f} TFLOP/s of fp32 work), bound "
            f"{b_ms * 1e3:.2f} us by {b_by} (fp32 SIMT {simt_ms * 1e3:.2f}),"
            f" torch.matmul {plain_ms * 1e3:.2f} us ({plain_ms / ms:.3f} x)")
        del x, ws, got, plain
    torch.cuda.empty_cache()
    layer = [times[c] for c, *_ in DENSE_CASES if c.startswith("yi-9b")]
    row = {k: sum(t[k] for t in layer)
           for k in ("ms", "plain_ms", "bound_ms", "simt_ms")}
    log(f"[kernel] dense_3xtf32 a yi-9b layer at 1,020 rows: "
        f"{row['ms'] * 1e3:.2f} us against torch.matmul "
        f"{row['plain_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f}"
        f" us (3xTF32), {row['simt_ms'] * 1e3:.2f} us (fp32 SIMT)")
    return dict(row, name="dense_3xtf32", route="cuda",
                source="src/repro_torch/kernels/dense_3xtf32/dense_3xtf32.cu",
                replaces="none (XLA's products: jnp.einsum in "
                         "src/repro/models/attention.py and mlp.py)",
                max_abs_err=worst, bound_by=times["yi-9b wi"]["bound_by"],
                library_ms=row["plain_ms"], by_case=times)


def dense_launches_on_the_path(since: float) -> int:
    """The kernel's launches in the engines' prefills since ``since`` (the
    spans' ``tc_products``); no decode step may launch it."""
    spans = {name: tracing.TRACER.spans(name, since=since)
             for name in ("plain prefill", "suffix prefill", "decode step")}
    check(all(v is not None for v in spans.values()),
          "the tracer dropped spans of the serving phases")
    check(all(s.counts["tc_products"] == 0 for s in spans["decode step"]),
          "a decode step launched dense_3xtf32")
    prefills = spans["plain prefill"] + spans["suffix prefill"]
    n = sum(s.counts["tc_products"] for s in prefills)
    products = sum(s.counts["products"] for s in prefills)
    log(f"[kernel] dense_3xtf32 on the path: {n} launches for {products} "
        f"dense products in {len(prefills)} prefills; 0 in "
        f"{len(spans['decode step'])} decode steps")
    return n


#: (case, tokens) of ``moe_experts_phase``: deepseek-moe-16b's decode
#: steps at batch 1 and 3 (phase 13), the 16- and 256-token suffixes and
#: a 1,024-token prefill (the benchmark's documents), each at its
#: variant (skinny, tiled 32, tiled 64)
MOE_CASES = (("decode B=1", 1), ("decode B=3", 3), ("suffix 16", 16),
             ("suffix 256", 256), ("prefill 1024", 1024))
MOE_TOL = 1e-5  # of the largest |output|: fp32 sums in another order


def moe_bound(cfg, n: int, choices: int, experts: int):
    """The gate-up and down launches' bound (ms): each expert chosen read
    once, the tokens' rows and the rows in between read and written
    once; 2 x 3 x d x ff operations a choice (``kvbench/moe_bound.py``)."""
    d, ff = cfg.d_model, cfg.d_ff
    up, up_by = bound(4 * (experts * d * 2 * ff + n * d + choices * ff),
                      4.0 * choices * d * ff)
    down, down_by = bound(4 * (experts * ff * d + choices * (ff + 1)
                               + choices * d), 2.0 * choices * ff * d)
    return up + down, up_by if up >= down else down_by


def moe_experts_phase(dev, cfg, moe_p, n_kernels: int) -> dict:
    """``moe_experts`` against its plain version on the card at
    deepseek-moe-16b's widths (one layer's experts), tokens routed by its
    router: each ``MOE_CASES`` shape, every token sent to one expert, and
    the experts no token chose poisoned with NaN (read, they would show);
    each shape timed in a CUDA graph beside its bound and the plain
    version.  Returns the kernel row, means weighted by the decode case."""
    E, k = cfg.num_experts, cfg.experts_per_token
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    cfg_route = dataclasses.replace(cfg, norm_topk_prob=False)
    wi, wo = moe_p["wi"], moe_p["wo"]
    err, times = 0.0, {}

    def inputs(n: int):
        x = torch.randn(n, cfg.d_model, device=dev, generator=g)
        _, w, ids = moe_mod.route(moe_p, x[None], cfg_route)
        return x, ids[0].contiguous(), w[0].contiguous()

    for case, n in MOE_CASES + (("every token on expert 5", 64),):
        x, ids, w = inputs(n)
        if case.startswith("every"):
            ids = torch.stack([torch.randperm(E, device=dev, generator=g)
                               for _ in range(n)])[:, :k]
            ids[:, 0] = 5
            ids[:, 1:] = torch.where(ids[:, 1:] == 5, E - 1, ids[:, 1:])
            ids = ids.contiguous()
        want, used = moe_experts_ref(x, ids, w, wi, wo)
        got, got_used = moe_ops.moe_experts(x, ids, w, wi, wo)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        e = (got - want).abs().max().item()
        check(e <= MOE_TOL * scale and int(got_used) == int(used),
              f"moe_experts kernel != plain version ({case}: max abs err "
              f"{e:.3g} of {scale:.3g}, experts {int(got_used)} vs "
              f"{int(used)})")
        err = max(err, e / scale)
        if n <= 16:
            # the experts not chosen poisoned: the kernel reads none of them
            chosen = torch.zeros(E, dtype=torch.bool, device=dev)
            chosen[ids.reshape(-1)] = True
            wi_p, wo_p = wi.clone(), wo.clone()
            wi_p[~chosen] = float("nan")
            wo_p[~chosen] = float("nan")
            again, _ = moe_ops.moe_experts(x, ids, w, wi_p, wo_p)
            check(torch.equal(again, got),
                  f"moe_experts read an expert no token chose ({case})")
            del wi_p, wo_p
        if case.startswith("every"):
            continue
        variant, bm = moe_ops.plan(n * k, E)
        ms = graph_ms(lambda: moe_ops.moe_experts(x, ids, w, wi, wo))
        plain_ms = time_ms(lambda: moe_experts_ref(x, ids, w, wi, wo),
                           iters=5, reps=3)
        b_ms, b_by = moe_bound(cfg, n, n * k, int(used))
        times[case] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by)
        log(f"[kernel] moe_experts {case} (n {n}, {n * k} choices, "
            f"{int(used)} experts, variant {variant}, {bm}-row tiles): "
            f"within {MOE_TOL} of the plain version's largest |out|; "
            f"{n_kernels} CUDA kernels per call; device {ms * 1e3:.2f} "
            f"us/call, bound {b_ms * 1e3:.2f} us by {b_by} "
            f"({100 * b_ms / ms:.1f} %), plain {plain_ms * 1e3:.2f} us")
    torch.cuda.empty_cache()
    return dict(times["decode B=1"], name="moe_experts", route="cuda",
                source="src/repro_torch/kernels/moe_experts/moe_experts.cu",
                replaces="none (XLA: src/repro/models/moe.py apply_moe)",
                max_abs_err=err, library_ms=None, by_case=times)


# -- phase 14: the reduced zoo, card against CPU -------------------------------

def zoo_inputs(cfg, n_text: int):
    """(tokens, embeds, mask_positions) of a batch of 2, per frontend."""
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, n_text)))
    if cfg.frontend == "none":
        return tokens, None, None
    n_emb = cfg.num_patch_tokens if cfg.frontend == "vision" else n_text
    embeds = torch.as_tensor(
        rng.standard_normal((2, n_emb, cfg.d_model)).astype(np.float32)
        * 0.02)
    if cfg.frontend == "vision":
        return tokens, embeds, None
    return None, embeds, torch.as_tensor(rng.random((2, n_text)) < 0.2)


def zoo_run(cfg, params, inputs, dev):
    """forward_full, then prefill + decode_step for a decoder (a 72-token
    prompt, past the reduced 64-token windows, and 4 steps).  Returns the
    logits and aux on the host, and every MoE layer's routing."""
    tokens, embeds, mask = (None if x is None else x.to(dev) for x in inputs)
    routes = []
    route = moe_mod.route

    def recorded(p, x, cfg_):
        out = route(p, x, cfg_)
        routes.append((out[0].cpu(), out[2].cpu()))
        return out

    with mock.patch.object(moe_mod, "route", recorded):
        logits, aux = tf.forward_full(params, cfg, tokens=tokens,
                                      embeds=embeds, mask_positions=mask)
        steps = []
        if cfg.supports_decode:
            n_emb = 0 if embeds is None else embeds.shape[1]
            cache = tf.init_cache(cfg, 2, n_emb + 76, device=dev)
            lg, cache = tf.prefill(params, cfg, tokens=tokens[:, :72],
                                   embeds=embeds, cache=cache)
            steps.append(lg[:, 0])
            for i in range(72, 76):
                lg, cache = tf.decode_step(params, cfg, tokens[:, i],
                                           n_emb + i, cache)
                steps.append(lg)
    return (logits.cpu(), float(aux), [x.cpu() for x in steps], routes)


def zoo_reference(dev) -> None:
    """Each of the ten assigned archs, reduced, from weights drawn on the
    CPU: the card's logits within 2e-4 of the largest |logit| of the
    CPU's, the MoE aux within 1e-5.  A top-k routing choice or an argmax
    that differs is logged with its margin on the CPU."""
    for arch in ASSIGNED_ARCHS:
        cfg = reduce_config(get_config(arch))
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
        inputs = zoo_inputs(cfg, 76)
        (lg, aux, steps, routes), (lg_d, aux_d, steps_d, routes_d) = (
            zoo_run(cfg, params, inputs, "cpu"),
            zoo_run(cfg, to_device(params, dev), inputs, dev))
        errs = []
        for what, a, b in [("forward", lg, lg_d)] + [
                (f"step {i}", x, y) for i, (x, y) in enumerate(
                    zip(steps, steps_d))]:
            e, scale = (b - a).abs().max().item(), a.abs().max().item()
            errs.append(e / scale)
            flips = (a.argmax(-1) != b.argmax(-1)).nonzero().tolist()
            for idx in flips:
                top2 = torch.topk(a[tuple(idx)], 2).values
                log(f"[zoo] {arch} {what}: argmax differs at {idx}, CPU "
                    f"top-2 margin {(top2[0] - top2[1]).item():.4g}")
            check(e <= LOGIT_TOL * scale,
                  f"{arch} {what}: card logits off by {e} of {scale}")
        check(abs(aux - aux_d) <= 1e-5, f"{arch}: aux {aux_d} != {aux}")
        n_diff = 0
        for (probs, tope), (_, tope_d) in zip(routes, routes_d):
            k = tope.shape[-1]
            for idx in (tope != tope_d).any(-1).nonzero().tolist():
                n_diff += 1
                p = torch.sort(probs[tuple(idx)], descending=True).values
                log(f"[zoo] {arch}: top-{k} choice differs at {idx}, CPU "
                    f"margin {(p[k - 1] - p[k]).item():.4g}")
        window = cfg.sliding_window or cfg.local_window
        log(f"[zoo] reduced {arch}: card == CPU within {max(errs):.3g} of "
            f"the largest |logit| (forward"
            + (f", a 72-token prefill"
               + (f" past its {window}-token window" if window else "")
               + f" and {len(steps) - 1} decode steps" if steps else "")
            + f"); aux {aux_d:.6g}"
            + (f"; {len(routes)} MoE routings, {n_diff} token(s) routed "
               f"differently" if routes else ""))


# -- phase 14b: a train step of the reduced zoo, card against CPU ------------

def zoo_train_reference(dev) -> None:
    """One ``make_train_step`` of each of the ten assigned archs, reduced,
    from weights drawn on the CPU and the same batch, on the card and on
    the CPU: loss and grad norm within ``TRAIN_TOL`` relative, the updated
    parameters within ``PARAM_ATOL`` (the envelope of Adam's sign flips
    that tests/test_training.py allows at lr 1e-3); reduced mamba2 through
    both of ``ssd_scan``'s kernels."""
    opt = AdamW(lr=constant_schedule(1e-3))
    for arch in ASSIGNED_ARCHS:
        cfg = reduce_config(get_config(arch))
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in next(batches(
            cfg, DataConfig(batch_size=2, seq_len=32, seed=SEED + 4))).items()}
        out = []
        for d in ("cpu", dev):
            # a copy on each device: the step updates it in place
            p = tree_map(lambda t: t.to(d, copy=True), params)
            state = TrainState(p, opt.init(p),
                               torch.zeros((), dtype=torch.int32, device=d))
            ssd_ops.launches = ssd_ops.bwd_launches = 0
            state, m = make_train_step(cfg, opt)(
                state, {k: v.to(d) for k, v in batch.items()})
            n = cfg.num_layers if d != "cpu" and arch == "mamba2-2.7b" else 0
            check((ssd_ops.launches, ssd_ops.bwd_launches) == (2 * n, n),
                  f"{arch} on {d}: ssd_scan {ssd_ops.launches} and backward "
                  f"{ssd_ops.bwd_launches} launches, not {2 * n} and {n}")
            out.append(({k: float(v) for k, v in m.items()},
                        to_device(state.params, "cpu")))
        (m0, p0), (m1, p1) = out
        rel = {k: abs(m1[k] - m0[k]) / abs(m0[k]) for k in ("loss",
                                                            "grad_norm")}
        for k, r in rel.items():
            check(r <= TRAIN_TOL, f"{arch}: {k} {m1[k]} on the card, "
                  f"{m0[k]} on the CPU")
        worst = max((a - b).abs().max().item()
                    for (_, a), (_, b) in zip(flatten(p0), flatten(p1)))
        check(worst <= PARAM_ATOL, f"{arch}: updated parameters differ by "
              f"{worst}")
        log(f"[zoo] reduced {arch} train step: card == CPU, loss "
            f"{m1['loss']:.6f} (rel {rel['loss']:.3g}), grad_norm "
            f"{m1['grad_norm']:.6f} (rel {rel['grad_norm']:.3g}); updated "
            f"parameters within {worst:.3g}"
            + ("; ssd_scan and its backward on the card"
               if arch == "mamba2-2.7b" else ""))


# -- phase 15: the dry run ----------------------------------------------------

# the two full-width combinations traced on the production meshes, and the
# ssd_scan calls the Mamba2 one must trace (one per layer)
DRYRUN_CASES = (("mamba2-2.7b", "prefill_32k", "single"),
                ("yi-9b", "decode_32k", "multipod"))
DRYRUN_SCANS = 64


def dryrun_phase(dev) -> None:
    """``ssd_scan``'s two custom ops through ``torch.library.opcheck`` on
    the card (the fake implementation against the kernel's outputs), then
    the dry run of ``DRYRUN_CASES`` in child processes (the fake process
    group of 256 or 512 ranks must not meet phase 5d's group)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 15)

    def f(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    for s in (128, 100):
        args = (f(2, s, 4, 32), -torch.nn.functional.softplus(f(2, s, 4)),
                f(2, s, 1, 16), f(2, s, 1, 16))
        ssd_ops.launches = ssd_ops.bwd_launches = 0
        torch.library.opcheck(torch.ops.repro_torch.ssd_scan_fwd.default,
                              args + (SCAN_CHUNK,))
        torch.library.opcheck(torch.ops.repro_torch.ssd_scan_bwd.default,
                              args + (f(2, s, 4, 32), f(2, 4, 32, 16),
                                      SCAN_CHUNK))
        check(ssd_ops.launches > 0 and ssd_ops.bwd_launches > 0,
              f"opcheck at s {s} launched no kernel")
        log(f"[dryrun] opcheck of ssd_scan_fwd and ssd_scan_bwd at b 2, s "
            f"{s}, nh 4, hd 32, S 16 holds on the card ({ssd_ops.launches} "
            f"and {ssd_ops.bwd_launches} launches)")
    out = ROOT / "build" / "dryrun_phase15"
    t0 = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        cwd=ROOT, env={**os.environ,
                       "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape, mesh in DRYRUN_CASES]
    for (arch, shape, mesh), child in zip(DRYRUN_CASES, children):
        text, _ = child.communicate(timeout=600)
        check(child.returncode == 0,
              f"dry run of {arch} x {shape} x {mesh} exited "
              f"{child.returncode}:\n{text[-3000:]}")
        rec = json.loads((out / f"{arch}.{shape}.{mesh}.json").read_text())
        check(rec["status"] == "ok", f"{arch} x {shape} x {mesh}: "
              f"{rec['status']} {rec.get('error', '')}")
        mem = rec["device_memory"]
        check(mem["allocated_before"] == mem["allocated_after"],
              f"{arch}: the trace moved the card's allocated memory {mem}")
        scans = rec["custom_op_calls"].get("repro_torch::ssd_scan_fwd", 0)
        want = DRYRUN_SCANS if arch == "mamba2-2.7b" else 0
        check(scans == want, f"{arch}: {scans} ssd_scan_fwd calls traced, "
              f"not {want}")
        rf, coll = rec["roofline"], rec["collectives"]
        log(f"[dryrun] {arch} x {shape} x {mesh} ({rec['n_devices']} fake "
            f"ranks): ok, trace {rec['trace_s']} s, wall {rec['wall_s']} s;"
            f" compute {rf['compute_s']:.6g} s, memory {rf['memory_s']:.6g} "
            f"s, collective {rf['collective_s']:.6g} s (modeled for the "
            f"H100 SXM's peaks), dominant {rf['dominant']}; per device "
            f"{rec['flops']:.6g} FLOPs, {rf['hlo_bytes_per_device']:.6g} "
            f"bytes; collectives "
            + ", ".join(f"{k} {coll[k]:.6g} B x{coll['counts'][k]}"
                        for k in coll["counts"])
            + f"; ssd_scan_fwd calls {scans}; card allocated "
            f"{mem['allocated_before']} B before and after")
    log(f"[dryrun] phase 15 wall {time.perf_counter() - t0:.2f} s")


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke.py: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; TF32 off for matmul and cudnn")

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(reports)} kernels built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    counts = {name: c["kernels"] for name, c in kernel_counts().items()}
    (cfg, params, store, man, prefix, prompts, plain, kv_k,
     kv_v) = set_up(dev)
    check([len(p) + NEW_TOKENS - 1 for p in prompts]
          + [len(plain) + NEW_TOKENS - 1] == DECODE_CTX,
          "the path's decode contexts differ from DECODE_CTX")
    kv_row = kv_restore_phase(dev, cfg, man, counts["kv_restore_layers"],
                              frame_timing=True)
    rans_row = rans_decode_phase(dev, cfg, man, counts["rans_decode"],
                                 kv=(kv_k, kv_v))
    dense_row = dense_3xtf32_phase(dev, counts["dense_3xtf32"])
    t_serve = time.monotonic()
    rows = [kv_row]
    attn = {}
    for case, arch, lens, width, seed in ATTN_CASES:
        if arch == DS_ARCH:
            continue  # phase 12
        c = get_config(arch)
        attn[case] = paged_attention_case(
            dev, c.num_heads, c.num_kv_heads, c.head_dim, PAGE_SIZE, lens,
            width, seed, counts[f"paged_attention {case}"])
    td_rows, td_launches = token_delta_phase(dev, cfg, man)
    rows += td_rows

    frames = {}  # the codec's dequantized frames, shared by the page checks
    launches, wall_outputs = main_path(dev, cfg, params, store, man, prefix,
                                       prompts, plain, frames)
    launches.update(td_launches)
    virtual = virtual_path(dev, cfg, params, store, man, prefix, prompts,
                           plain, wall_outputs, frames)
    sharded, sharded_batches = sharded_path(
        dev, cfg, params, store, man, prefix, prompts, plain, wall_outputs,
        virtual, frames)
    check(set(sharded_batches) <= {1, 2},
          f"phase 5d decoded batches of {sorted(sharded_batches)}")
    stored, anc = storage_path(dev, cfg, params, man, prefix, prompts,
                               kv_k, kv_v, wall_outputs, frames)
    fleet, fleet_shapes = fleet_path(
        dev, cfg, params, man, int(kv_k.nbytes + kv_v.nbytes), anc, prefix,
        prompts, plain, wall_outputs, frames)
    del anc
    # paged_attention runs at many shapes: the batch of three in phase 4,
    # one request alone in phases 5b and 5d, two in 5d, the fleet's decode
    # steps in phase 5c and deepseek-moe-16b's batch of three in phase 13.
    # Each is held, timed and counted on its own (5b's and 5d's at their
    # last step's contexts); the row's times are their means weighted by
    # launches
    per_shape = {"lwm-7b": launches["paged_attention"],
                 "lwm-7b B=1": stored["paged_attention"]
                 + sharded_batches.get(1, 0),
                 "lwm-7b B=2": sharded_batches.get(2, 0)}
    for case, _, lens, width, _ in ATTN_CASES:
        if (tuple(lens), width) in fleet_shapes and case.startswith(
                "lwm-7b"):
            per_shape[case] = fleet_shapes[tuple(lens), width]
    for name, n in stored.items():
        launches[name] += n + fleet[name] + sharded[name]
    # kv_restore likewise, by the chunk shapes of lwm-7b's groups
    kv_shapes = {("lwm-7b", G): launches["kv_restore"] * share
                 for G, share in restores_by_group(man).items()}
    kv_times = {("lwm-7b", G): t for G, t in kv_row["by_group"].items()}
    rans_times = {("lwm-7b", G): t for G, t in rans_row["by_group"].items()}
    del params, store, man, kv_k, kv_v, frames
    torch.cuda.empty_cache()
    small_reference(dev)

    m_cfg, m_params, m_prefix, m_prompts = mamba_set_up(dev)
    rows.append(ssd_scan_phase(dev, m_cfg, counts["ssd_scan"]))
    rows.append(ssd_scan_bwd_phase(dev, m_cfg, counts["ssd_scan_bwd"],
                                   rows[-1]["ms"]))
    launches["ssd_scan"] = mamba_path(dev, m_cfg, m_params, m_prefix,
                                      m_prompts)
    del m_params
    torch.cuda.empty_cache()
    small_mamba_reference(dev)
    t_phase = time.perf_counter()
    trained = train_path(dev)
    log(f"[train] phase 10b wall {time.perf_counter() - t_phase:.2f} s")
    launches["ssd_scan"] += trained["ssd_scan"]
    launches["ssd_scan_bwd"] = trained["ssd_scan_bwd"]

    # deepseek-moe-16b at full width: set-up, its kernel shapes, its path
    t_phase = time.perf_counter()
    (d_cfg, d_params, d_store, d_man, d_prefix, d_prompts, d_plain, _,
     _) = set_up(dev, DS_ARCH, "moe")
    check(n_params(d_params) == DS_PARAMS,
          f"{DS_ARCH}: {n_params(d_params)} parameters, not {DS_PARAMS}")
    check([len(p) + NEW_TOKENS - 1 for p in d_prompts]
          + [len(d_plain) + NEW_TOKENS - 1] == DECODE_CTX,
          f"{DS_ARCH}'s decode contexts differ from DECODE_CTX")
    log(f"[moe] layer groups {[len(g) for g in d_man.layer_groups]} "
        f"({d_cfg.num_layers} layers: {len(d_man.layer_groups) - 1} groups "
        f"of 3 and a remainder group of {len(d_man.layer_groups[-1])}); "
        f"{expected_restores(d_cfg, d_man)} chunks per fetch")
    d_kv = kv_restore_phase(
        dev, d_cfg, d_man, counts[f"kv_restore_layers {DS_ARCH} G=3"],
        frame_timing=False)
    kv_row["max_abs_err"] = max(kv_row["max_abs_err"], d_kv["max_abs_err"])
    kv_times.update({(DS_ARCH, G): t for G, t in d_kv["by_group"].items()})
    d_rans = rans_decode_phase(dev, d_cfg, d_man, counts["rans_decode"])
    rans_times.update({(DS_ARCH, G): t
                       for G, t in d_rans["by_group"].items()})
    for case, arch, lens, width, seed in ATTN_CASES:
        if arch == DS_ARCH:
            attn[case] = paged_attention_case(
                dev, d_cfg.num_heads, d_cfg.num_kv_heads, d_cfg.head_dim,
                PAGE_SIZE, lens, width, seed,
                counts[f"paged_attention {case}"])
    moe_row = moe_experts_phase(dev, d_cfg, d_params["layers"][1]["moe"],
                                counts["moe_experts"])
    d_launches = moe_path(dev, d_cfg, d_params, d_store, d_man, d_prefix,
                          d_prompts, d_plain, {})
    per_shape[DS_ARCH] = d_launches["paged_attention"]
    kv_shapes.update({(DS_ARCH, G): d_launches["kv_restore"] * share
                      for G, share in restores_by_group(d_man).items()})
    for name, n in d_launches.items():
        launches[name] = launches.get(name, 0) + n
    launches["dense_3xtf32"] = dense_launches_on_the_path(t_serve)
    del d_params, d_store, d_man
    torch.cuda.empty_cache()
    log(f"[moe] phases 11-13 wall {time.perf_counter() - t_phase:.2f} s")
    small_engine(dev, DS_ARCH, num_layers=4)
    zoo_reference(dev)
    zoo_train_reference(dev)
    dryrun_phase(dev)

    n_pa = sum(per_shape.values())
    check(launches["paged_attention"] == n_pa,
          "paged_attention's launches by shape do not add up")
    for case, n in per_shape.items():
        a = attn[case]
        log(f"[kernel] paged_attention {case}: {n} launches on the path; "
            f"device {a['ms'] * 1e3:.2f} us/call, bound "
            f"{a['bound_ms'] * 1e3:.3f} us, plain {a['plain_ms'] * 1e3:.2f}"
            f" us, SDPA {a['library_ms'] * 1e3:.2f} us; loss over the "
            f"bound {n * (a['ms'] - a['bound_ms']):.3f} ms per run")
    row = dict(attn["lwm-7b"], max_abs_err=max(
        attn[c]["max_abs_err"] for c in per_shape),
        bound_by=attn[max(per_shape, key=per_shape.get)]["bound_by"])
    for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
        row[k] = sum(n * attn[c][k] for c, n in per_shape.items()) / n_pa
    rows.insert(1, row)
    fleet_loss = sum(n * (attn[c]["ms"] - attn[c]["bound_ms"])
                     for c, n in per_shape.items() if c.startswith(
                         "lwm-7b fleet"))
    log(f"[kernel] paged_attention over the path's {n_pa} launches: mean "
        f"{row['ms'] * 1e3:.2f} us/call, bound {row['bound_ms'] * 1e3:.3f} "
        f"us; loss over the bound {n_pa * (row['ms'] - row['bound_ms']):.3f}"
        f" ms per run, of it the fleet's {fleet_loss:.3f} ms")
    n_kv = sum(kv_shapes.values())
    check(round(n_kv) == launches["kv_restore"],
          "kv_restore's launches by shape do not add up")
    for (arch, G), n in kv_shapes.items():
        t = kv_times[arch, G]
        log(f"[kernel] kv_restore_layers {arch} G={G}: {n:.0f} launches on "
            f"the path; device {t['ms'] * 1e3:.2f} us/launch, bound "
            f"{t['bound_ms'] * 1e3:.4f} us, plain {t['plain_ms'] * 1e3:.2f} "
            f"us; loss over the bound {n * (t['ms'] - t['bound_ms']):.3f} "
            f"ms per run")
    for k in ("ms", "plain_ms", "bound_ms"):
        kv_row[k] = sum(n * kv_times[s][k] for s, n in kv_shapes.items()) \
            / n_kv
    kv_row["bound_by"] = kv_times[max(kv_shapes, key=kv_shapes.get)][
        "bound_by"]
    log(f"[kernel] kv_restore over the path's {launches['kv_restore']} "
        f"launches: mean {kv_row['ms'] * 1e3:.2f} us/launch, bound "
        f"{kv_row['bound_ms'] * 1e3:.4f} us")
    # rans_decode decodes every chunk that kv_restore restores: the same
    # launches at the same chunk shapes
    check(launches["rans_decode"] == launches["kv_restore"],
          f"rans_decode {launches['rans_decode']} launches, kv_restore "
          f"{launches['kv_restore']}")
    for (arch, G), n in kv_shapes.items():
        t = rans_times[arch, G]
        log(f"[kernel] rans_decode {arch} G={G}: {n:.0f} launches on the "
            f"path; device {t['ms'] * 1e3:.2f} us/launch, bound "
            f"{t['bound_ms'] * 1e3:.4f} us, plain {t['plain_ms']:.2f} ms on "
            f"the host; loss over the bound "
            f"{n * (t['ms'] - t['bound_ms']):.3f} ms per run")
    for k in ("ms", "plain_ms", "bound_ms"):
        rans_row[k] = sum(n * rans_times[s][k]
                          for s, n in kv_shapes.items()) / n_kv
    log(f"[kernel] rans_decode over the path's {launches['rans_decode']} "
        f"launches: mean {rans_row['ms'] * 1e3:.2f} us/launch, bound "
        f"{rans_row['bound_ms'] * 1e3:.4f} us")
    rows.append(rans_row)
    rows.append(moe_row)
    rows.append(dense_row)

    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(count_kernels_child() if sys.argv[1:] == ["--kernel-counts"]
             else main())
