#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA device and
``nvcc`` (``/usr/local/cuda`` or ``$CUDA_HOME``), and imports nothing of
JAX or of the JAX package.  Phases:

1. build: compile every CUDA kernel of the main path from the sources in
   the checkout (one ``nvcc`` per source, all at once), timed;
2. set-up: lwm-7b at full width (32 layers, d 4096, 32 heads, hd 128,
   ff 11008, vocab 32000) with random fp32 weights from a seeded
   ``torch.Generator``; a donor prefills a 512-token prefix and registers
   it, encoded by the host codec, in a ``KVStore``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (``kv_restore`` bit-equal, including a real
   token in row 0 beside dropped tokens; ``paged_attention`` within
   1e-4, also at yi-34b's GQA head shape), with times beside the bound;
4. main path: a ``LiveEngine`` serves two requests that fetch the prefix
   and one plain request, 16 new tokens each; the kernels' launch counts
   are set to 0 just before and read just after, and must equal what the
   path implies; the restored pages must equal the codec's dequantized
   frames bit for bit;
5. reference: the same engine at a reduced size on the card and on the
   CPU (plain versions) must generate the same tokens.

TF32 is switched off for matrix products and convolutions, so every fp32
product runs in full fp32.  Any failed check raises and the script exits
non-zero.  The last lines are the kernel table as JSON, the card's name
and power limit, and the result line.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch is missing)")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.cluster.storage import KVStore  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.chunks import decode_chunk_tokens, prefix_key  # noqa: E402
from repro_torch.core.codec import KVCodec  # noqa: E402
from repro_torch.core.layout import IntraLayout  # noqa: E402
from repro_torch.data.workload import shared_prefix_tokens  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.kv_restore import ops as kv_ops  # noqa: E402
from repro_torch.kernels.kv_restore.ref import kv_restore_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serving import paged_model  # noqa: E402
from repro_torch.serving.engine import LiveEngine  # noqa: E402

SEED = 0
PREFIX_TOKENS = 512
SUFFIX_TOKENS = 16
NEW_TOKENS = 16
TOKENS_PER_CHUNK = 16
RESOLUTION = "240p"
N_PAGES = 128
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
ATTN_TOL = 1e-4


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


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: model, donor, store --------------------------------------------

def set_up(dev):
    cfg = get_config("lwm-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["final_norm"],
                                        params["lm_head"]])
    n_params += sum(t.numel() for lp in params["layers"]
                    for v in lp.values()
                    for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"[setup] lwm-7b full width, {n_params / 1e9:.3f} B fp32 params, "
        f"init {time.perf_counter() - t0:.2f} s")
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
    log(f"[setup] donor prefill {PREFIX_TOKENS} tokens {t_prefill:.2f} s; "
        f"host encode {time.perf_counter() - t0:.2f} s, "
        f"{store.stored_bytes()} bytes in {len(man.refs)} chunks, "
        f"layout {man.layout}")
    return cfg, params, store, man, prefix, prompts, plain


# -- phase 3: kernels against their plain versions ---------------------------

def kv_restore_phase(dev, cfg, man):
    lay = IntraLayout(cfg.num_kv_heads, cfg.head_dim, *man.layout)
    codec = KVCodec(cfg.num_kv_heads, cfg.head_dim, lay)
    blob = man.blobs[(man.refs[0].chunk_id, RESOLUTION)]
    toks, qt = next(codec.iter_decode_frames(blob))
    n, H, D = qt.shape[0], cfg.num_kv_heads, cfg.head_dim
    R = N_PAGES * 16
    g = torch.Generator(device=dev).manual_seed(1)
    pages = torch.randn(R, H, D, device=dev, generator=g)
    q = torch.as_tensor(np.ascontiguousarray(qt[:, 0]), device=dev)
    scales = torch.as_tensor(man.scales["k"][0], device=dev)
    rows = (torch.randperm(R - 1, device=dev, generator=g)[:n] + 1).to(
        torch.int32)  # distinct rows >= 1, so row 0 below is unique
    err = 0.0
    # the main path's frame, then row 0 beside dropped tokens
    dropped = rows.clone()
    dropped[0] = 0
    dropped[1::3] = -1
    for sl in (rows, dropped):
        want = kv_restore_ref(pages.clone(), q, scales, sl)
        got = kv_ops.kv_restore(pages.clone(), q, scales, sl)
        torch.cuda.synchronize()
        check(torch.equal(got, want), "kv_restore kernel != plain version")
        err = max(err, (got - want).abs().max().item())
    ms = graph_ms(lambda: kv_ops.kv_restore(pages, q, scales, rows))
    eager_ms = time_ms(lambda: kv_ops.kv_restore(pages, q, scales, rows))
    # the plain version's boolean-mask scatter synchronises with the host,
    # so it cannot be captured: its time includes that round trip
    plain_ms = time_ms(lambda: kv_restore_ref(pages, q, scales, rows))
    n_bytes = n * H * D * (1 + 4) + H * 4 + n * 4
    b_ms, b_by = bound(n_bytes, 2 * n * H * D)
    log(f"[kernel] kv_restore n={n} H={H} D={D}: bit-equal, device "
        f"{ms * 1e3:.2f} us/launch (eager call from Python "
        f"{eager_ms * 1e3:.2f} us; plain version {plain_ms * 1e3:.2f} us "
        f"eager; bound {b_ms * 1e3:.4f} us by {b_by})")
    return dict(name="kv_restore", route="cuda",
                source="src/repro_torch/kernels/kv_restore/kv_restore.cu",
                replaces="src/repro/kernels/kv_restore/kv_restore.py:35",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def paged_attention_case(dev, H, K, hd, ps, lens, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    bps = max(-(-n // ps) for n in lens) + 2  # padded tables, as the cache
    P = B * bps
    q = torch.randn(B, H, hd, device=dev, generator=g)
    kp = torch.randn(P, ps, K, hd, device=dev, generator=g)
    vp = torch.randn(P, ps, K, hd, device=dev, generator=g)
    bt = torch.randperm(P, device=dev, generator=g)[:B * bps]
    bt = bt.reshape(B, bps).to(torch.int32)
    cl = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = paged_attention_ref(q, kp, vp, bt, cl)
    got = pa_ops.paged_attention(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(err <= ATTN_TOL, f"paged_attention kernel off by {err}")
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
    log(f"[kernel] paged_attention H={H} K={K} hd={hd} ps={ps} ctx={lens}: "
        f"max_abs_err {err:.3g}, device {ms * 1e3:.2f} us/launch (eager "
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


# -- phase 4: the main path ---------------------------------------------------

def expected_restores(cfg, man) -> int:
    """kv_restore launches for one fetch of ``man``: frames x layers, summed
    over the chunks of both kinds."""
    lay = IntraLayout(cfg.num_kv_heads, cfg.head_dim, *man.layout)
    codec = KVCodec(cfg.num_kv_heads, cfg.head_dim, lay)
    return sum(codec.frame_count(man.blobs[(r.chunk_id, RESOLUTION)])
               * len(r.layers) for r in man.refs)


def check_restored_pages(eng, cfg, man, rid) -> None:
    rows = torch.as_tensor(eng.cache.slots_for(rid, np.arange(man.n_tokens)),
                           device=eng.device).long()
    for r in man.refs:
        deq = decode_chunk_tokens(man, r.chunk_id, RESOLUTION,
                                  cfg.num_kv_heads, cfg.head_dim)
        pages = eng.cache.k_pages if r.kind == "k" else eng.cache.v_pages
        for li, layer in enumerate(r.layers):
            got = eng.cache.layer_rows(pages, layer)[
                rows[r.token_start:r.token_end]].cpu().numpy()
            check(np.array_equal(got, deq[:, li]),
                  f"rid {rid}: restored {r.chunk_id} layer {layer} differs "
                  f"from the codec's dequantized frames")


def profile_step(eng) -> bool:
    """One decode step under torch.profiler: device busy share and the
    operators that take the most device and host time.  Returns what
    ``eng.step()`` returned."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        busy = eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        (kernels if on_device else ops).append(
            (dev_us if on_device else e.self_cpu_time_total, e.count, e.key))
    busy_ms = sum(k[0] for k in kernels) / 1e3
    n_launch = sum(k[1] for k in kernels)
    log(f"[profile] one decode step: wall {wall_ms:.2f} ms (profiled), "
        f"{n_launch} kernels, device busy {busy_ms:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for us, count, key in sorted(kernels, reverse=True)[:6]:
        log(f"[profile]   kernel  device {us / 1e3:8.3f} ms  x{count:<5d} "
            f"{key[:60]}")
    for us, count, key in sorted(ops, reverse=True)[:6]:
        log(f"[profile]   host op host   {us / 1e3:8.3f} ms  x{count:<5d} "
            f"{key[:60]}")
    return busy


def serve(dev, cfg, params, store, key, prompts, plain, reuse: bool):
    eng = LiveEngine(params, cfg, store, n_pages=N_PAGES, device=dev)
    reqs = [eng.submit(p, reuse_prefix=key if reuse else None,
                       reuse_tokens=PREFIX_TOKENS if reuse else 0,
                       max_new_tokens=NEW_TOKENS) for p in prompts]
    reqs.append(eng.submit(plain, max_new_tokens=NEW_TOKENS))
    return eng, reqs


def main_path(dev, cfg, params, store, man, prefix, prompts, plain):
    key = prefix_key(prefix)
    eng, reqs = serve(dev, cfg, params, store, key, prompts, plain, True)
    reuse_reqs = reqs[:2]
    step_ms, profiled, checked = [], False, False
    torch.cuda.synchronize()
    kv_ops.launches = 0
    pa_ops.launches = 0
    busy = True
    while busy:
        prefilled = all(r.t_first_token is not None for r in reqs)
        if prefilled and not profiled and len(step_ms) == 4:
            busy, profiled = profile_step(eng), True
            continue
        t0 = time.perf_counter()
        busy = eng.step()
        torch.cuda.synchronize()
        if prefilled:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        if not checked and all(r.t_first_token is not None
                               for r in reuse_reqs):
            # pages still held: compare them before the sequences finish
            n_kv, n_pa = kv_ops.launches, pa_ops.launches
            for r in reuse_reqs:
                check_restored_pages(eng, cfg, man, r.rid)
            checked = (n_kv, n_pa) == (kv_ops.launches, pa_ops.launches)
            check(checked, "page check launched a kernel")
    launches = {"kv_restore": kv_ops.launches,
                "paged_attention": pa_ops.launches}
    check(len(eng.finished) == len(reqs), "not every request finished")
    for r in reqs:
        out = eng.outputs[r.rid]
        check(len(out) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in out),
              f"rid {r.rid}: bad output {out}")
    decode_steps = len({t for r in reqs for t in r.token_times[1:]})
    want = {"kv_restore": 2 * expected_restores(cfg, man),
            "paged_attention": cfg.num_layers * decode_steps}
    log(f"[main] launches {launches}, expected {want} "
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
        log(f"[main] rid {r.rid} ({'reuse' if r.reuse_tokens else 'plain'})"
            f": TTFT {r.ttft:.3f} s{fetch}")
    log(f"[main] decode step ({len(reqs)} sequences, {cfg.num_layers} "
        f"layers): median {statistics.median(step_ms):.2f} ms over "
        f"{len(step_ms)} steps; "
        f"fetched {eng.stats.fetched_bytes} bytes, restore buffer high "
        f"water {eng.stats.restore_buffer_high_water} bytes")
    outputs = [eng.outputs[r.rid] for r in reqs]
    del eng
    torch.cuda.empty_cache()
    # not asserted: int8 KV at full width with random weights may flip an
    # argmax against a full prefill of the same prompt
    full, full_reqs = serve(dev, cfg, params, store, key, prompts, plain,
                            False)
    full.run()
    for r, got in zip(full_reqs[:2], outputs[:2]):
        log(f"[main] rid {r.rid}: reuse generation "
            f"{'matches' if full.outputs[r.rid] == got else 'differs from'}"
            f" a full prefill of the same prompt")
    del full
    torch.cuda.empty_cache()
    return launches


# -- phase 5: agreement with the plain versions at a small size ---------------

def small_reference(dev) -> None:
    cfg = reduce_config(get_config("lwm-7b"))
    params = init_params(cfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    rng = np.random.default_rng(SEED + 1)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, 48, 2, 8)
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    to_dev = lambda t: t.to(dev)  # noqa: E731
    dev_params = {k: (to_dev(v) if k != "layers" else
                      [{n: ({m: to_dev(w) for m, w in x.items()}
                            if isinstance(x, dict) else to_dev(x))
                        for n, x in lp.items()} for lp in v])
                  for k, v in params.items()}
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
    check(outs[0] == outs[1], f"card {outs[1]} != cpu {outs[0]}")
    log(f"[small] reduced lwm-7b on the card == on the CPU: {outs[1]}")


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

    cfg, params, store, man, prefix, prompts, plain = set_up(dev)
    ctx = [len(p) + NEW_TOKENS - 1 for p in prompts] + \
        [len(plain) + NEW_TOKENS - 1]
    rows = [kv_restore_phase(dev, cfg, man),
            paged_attention_case(dev, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, 16, ctx, 2)]
    yi = get_config("yi-34b")
    paged_attention_case(dev, yi.num_heads, yi.num_kv_heads, yi.head_dim,
                         16, ctx, 3)

    launches = main_path(dev, cfg, params, store, man, prefix, prompts,
                         plain)
    del params
    torch.cuda.empty_cache()
    small_reference(dev)

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
    sys.exit(main())
