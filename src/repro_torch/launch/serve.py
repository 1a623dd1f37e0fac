"""Serving launcher of the port: the live engine, on the card by default,
or the cluster simulation, on the host.

    PYTHONPATH=src python -m repro_torch.launch.serve --live
    PYTHONPATH=src python -m repro_torch.launch.serve --live --reduced \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b \
        --simulate --gbps 16 --context 100000 --method kvfetcher

``--live`` serves, for any registered decoder whose layers are all
attention (dense or MoE), the scenario of the JAX package's
``examples/serve_reuse.py``: a donor registers an encoded prefix, a
batch of requests sharing it fetches, decodes and restores it into
paged memory and prefills only its suffixes beside one plain request
(wall clock); their generations are compared with a full prefill; then
one reuse request streams its tokens over a modeled WAN (virtual clock,
``fetch_mode="async"``) through ``on_token``.  ``--arch`` names the
model (full width unless ``--reduced``), with random weights from seed
0, as the scenario's prompts are.

``--simulate`` runs the analytic ``ServingSimulator`` (numpy, no
device) over ``--requests`` back-to-back fetches of ``--context``
tokens on a constant ``--gbps`` link with ``--method``'s spec and
``--chip``'s decode table, and prints the TTFT/TPOT summary of the
fetching requests, as the JAX package's launcher does.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.cluster import simulator as sim
from repro_torch.cluster.network import BandwidthTrace
from repro_torch.cluster.storage import KVStore
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adaptive import TABLES
from repro_torch.core.chunks import prefix_key
from repro_torch.data.workload import fixed_context_trace, shared_prefix_tokens
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.params import init_params
from repro_torch.serving import paged_model
from repro_torch.serving.engine import LiveEngine
from repro_torch.serving.metrics import split_summary, summarize

PREFIX_LEN, SUFFIX_LEN, N_REQ, NEW_TOKENS = 96, 8, 3, 4
TOKENS_PER_CHUNK = 32
RESOLUTIONS = ("240p", "1080p")
WAN_GBPS = 0.5


def live_scenario(params, cfg: ModelConfig, *, device: DeviceLike = None,
                  log: Callable[[str], None] = print) -> Dict:
    """Serve the ``serve_reuse`` scenario on ``params``.  Returns its
    inputs (prefix, prompts, the plain prompt, the donor's K/V) and what
    came out (tokens, streamed tokens and times, ``split_summary``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, PREFIX_LEN,
                                           N_REQ, SUFFIX_LEN)
    plain_prompt = rng.integers(0, cfg.vocab_size, 24)

    # offline: the donor registers the encoded prefix
    log("== donor: encode + register prefix KV ==")
    kv_k, kv_v = paged_model.donor_prefix_kv(params, cfg, prefix)
    store = KVStore()
    key = prefix_key(prefix)
    man = store.register_prefix(prefix, kv_k, kv_v,
                                tokens_per_chunk=TOKENS_PER_CHUNK,
                                resolutions=RESOLUTIONS)
    raw = 2 * (kv_k.nbytes + kv_v.nbytes)
    log(f"  prefix {PREFIX_LEN} tokens -> {len(man.refs)} chunks, "
        f"{man.total_bytes('240p') / 1e3:.0f} kB at 240p "
        f"({raw / man.total_bytes('240p'):.1f}x vs fp16)")

    # online: batched serving with reuse beside one plain request
    log("== engine: mixed batch (reuse + non-reuse) ==")
    eng = LiveEngine(params, cfg, store, policy="kvfetcher", max_running=4,
                     device=dev)
    reqs = [eng.submit(p, reuse_prefix=key, reuse_tokens=PREFIX_LEN,
                       max_new_tokens=NEW_TOKENS) for p in prompts]
    plain = eng.submit(plain_prompt, max_new_tokens=NEW_TOKENS)
    eng.run()
    log(f"  served {len(eng.finished)} requests on {dev}")
    log(f"  restored tokens: {eng.stats.restored_tokens}, fetched "
        f"{eng.stats.fetched_bytes / 1e3:.0f} kB, restore buffer high-water "
        f"{eng.stats.restore_buffer_high_water / 1e3:.0f} kB")
    if len(eng.finished) != N_REQ + 1:
        raise RuntimeError(f"{len(eng.finished)} of {N_REQ + 1} requests "
                           f"finished")
    # counted once per restored chunk: k and v of every layer group
    if eng.stats.restored_tokens != \
            2 * len(man.layer_groups) * PREFIX_LEN * N_REQ:
        raise RuntimeError(f"restored {eng.stats.restored_tokens} tokens")

    # reuse against a full prefill: random weights give near-uniform
    # logits, so int8 KV can flip an argmax; reported, not asserted
    log("== verify: reuse vs full prefill ==")
    eng_ref = LiveEngine(params, cfg, KVStore(), max_running=4, device=dev)
    ref_req = eng_ref.submit(prompts[0], max_new_tokens=NEW_TOKENS)
    eng_ref.run()
    a, b = eng_ref.outputs[ref_req.rid], eng.outputs[reqs[0].rid]
    frac = sum(x == y for x, y in zip(a, b)) / len(a)
    log(f"  first token identical: {a[0] == b[0]}; token agreement "
        f"{frac:.0%} (random weights: argmax ties)")
    summary = split_summary(eng.finished)
    for name, s in summary.items():
        if s.get("n"):
            log(f"  {name:10s} n={s['n']:.0f} "
                f"ttft_mean={s.get('ttft_mean', 0):.2f}s")

    # streaming client view over the modeled WAN (virtual clock)
    log("== streaming: per-token client view (async WAN, virtual clock) ==")
    stream = []

    def client_view(req, tok, t):
        stream.append((req.rid, tok, t))
        tag = ("ttft" if len(stream) == 1
               else f"+{t - stream[0][2]:.3f}s")
        log(f"  rid={req.rid} token#{len(stream) - 1} -> {tok:4d} "
            f"at t={t:.3f}s ({tag})")

    eng_s = LiveEngine(params, cfg, store, policy="kvfetcher",
                       fetch_mode="async",
                       bandwidth=BandwidthTrace.constant(WAN_GBPS),
                       on_token=client_view, device=dev)
    sreq = eng_s.submit(prompts[0], reuse_prefix=key,
                        reuse_tokens=PREFIX_LEN, max_new_tokens=NEW_TOKENS)
    eng_s.run()
    toks = [tok for _, tok, _ in stream]
    if toks != eng_s.outputs[sreq.rid] \
            or [t for _, _, t in stream] != sreq.token_times:
        raise RuntimeError("the stream does not mirror the outputs")
    log(f"  streamed {len(toks)} tokens, ttft={sreq.t_first_token:.3f}s "
        f"(virtual); stream == outputs, times == token_times")
    return dict(prefix=prefix, prompts=prompts, plain_prompt=plain_prompt,
                kv_k=kv_k, kv_v=kv_v, key=key,
                outputs=[eng.outputs[r.rid] for r in reqs + [plain]],
                full_prefill=a, stream=toks,
                stream_times=list(sreq.token_times), summary=summary)


def simulate(args: argparse.Namespace) -> None:
    """The ``--simulate`` branch: one ``ServingSimulator`` run, its
    summary printed."""
    spec = {
        "kvfetcher": sim.kvfetcher_spec(
            {"240p": 9.0, "480p": 8.5, "640p": 8.0, "1080p": 7.0}),
        "cachegen": sim.cachegen_spec(3.5),
        "llm265": sim.llm265_spec(5.0),
        "raw": sim.raw_spec(),
        "lmcache_raw": sim.lmcache_raw_spec(),
        "full_prefill": sim.full_prefill_spec(),
    }[args.method]
    # the cost model has no TPU entry: tpu-v5e runs on h20's figures
    chip = "h20" if args.chip == "tpu-v5e" else args.chip
    s = sim.ServingSimulator(
        get_config(args.arch), spec, chip=chip, n_chips=2,
        bandwidth=BandwidthTrace.constant(args.gbps), table=TABLES[chip])
    res = s.run(fixed_context_trace(args.context,
                                    n_requests=args.requests, gap=60.0),
                max_new_tokens=16)
    reqs = res.fetching() or res.requests
    print(f"method={args.method} ctx={args.context} bw={args.gbps}Gbps")
    for k, v in summarize(reqs).items():
        print(f"  {k}: {v:.3f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="lwm-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced (smoke-size) configuration")
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--simulate", action="store_true")
    ap.add_argument("--method", default="kvfetcher",
                    choices=["kvfetcher", "cachegen", "llm265", "raw",
                             "lmcache_raw", "full_prefill"])
    ap.add_argument("--gbps", type=float, default=16.0)
    ap.add_argument("--context", type=int, default=100_000)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--chip", default="h20",
                    choices=["h20", "a100", "l20", "tpu-v5e"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.simulate and not args.live:
        simulate(args)
        return
    cfg = get_config(args.arch)
    if cfg.is_encoder or set(cfg.layer_kinds()) != {"attn"}:
        ap.error(f"--live serves decoders whose layers are all attention; "
                 f"{cfg.name} has {sorted(set(cfg.layer_kinds()))} layers"
                 f"{' (an encoder)' if cfg.is_encoder else ''}")
    if args.reduced:
        cfg = reduce_config(cfg)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    print(f"{cfg.name}: random weights from seed 0 on {dev}")
    live_scenario(params, cfg, device=dev)
    print("OK")


if __name__ == "__main__":
    main()
