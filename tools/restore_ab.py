#!/usr/bin/env python3
"""Time the lwm-7b reuse fetch of this checkout against another's, on one
card, in alternating turns.

    python3 tools/restore_ab.py --other DIR   # DIR: another checkout

The parent process builds the store once, as ``chip_smoke.py`` does: full
-width lwm-7b with random fp32 weights from a seeded ``torch.Generator``,
a donor prefill of a 512-token prefix, encoded by the host codec into
16-token chunks at 240p, pickled under ``build/``.  Each turn is a fresh
process that imports ``repro_torch`` from one checkout and serves two
reuse requests of that prefix, one after the other, on the wall clock
(``LiveEngine.step`` fetches, decodes and restores the whole prefix, then
prefills the 16-token suffix).  Per request it reports the TTFT, the
fetch time, and the host seconds spent in ``LiveEngine._restore_chunk``,
split into the host codec's frame decoder and everything else (staging,
slots, uploads, launches).  The turns run other, this, this, other; each
prints one JSON line, and the script ends with the card's name and power
limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import pickle
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
STORE = HERE / "build" / "restore_ab_store.pkl"
SEED, PREFIX, SUFFIX = 0, 512, 16


def build_store() -> None:
    sys.path.insert(0, str(HERE / "src"))
    import torch
    from repro_torch.cluster.storage import KVStore
    from repro_torch.configs import get_config
    from repro_torch.data.workload import shared_prefix_tokens
    from repro_torch.params import init_params
    from repro_torch.serving import paged_model
    import numpy as np

    dev = torch.device("cuda", 0)
    cfg = get_config("lwm-7b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    rng = np.random.default_rng(SEED)
    prefix, prompts = shared_prefix_tokens(rng, cfg.vocab_size, PREFIX, 2,
                                           SUFFIX)
    _, kvs = paged_model.prefill_collect_kv(
        params, cfg, torch.as_tensor(prefix[None], device=dev))
    kv_k = torch.stack([k[0] for k, _ in kvs], 1).cpu().numpy()
    kv_v = torch.stack([v[0] for _, v in kvs], 1).cpu().numpy()
    man = KVStore().register_prefix(prefix, kv_k, kv_v, tokens_per_chunk=16,
                                    resolutions=("240p",))
    STORE.parent.mkdir(parents=True, exist_ok=True)
    with open(STORE, "wb") as f:
        pickle.dump((man, prompts), f)


def turn(root: str) -> dict:
    sys.path.insert(0, str(pathlib.Path(root) / "src"))
    import torch
    from repro_torch.cluster.storage import KVStore
    from repro_torch.configs import get_config
    from repro_torch.core.codec import KVCodec
    from repro_torch.params import init_params
    from repro_torch.serving.engine import LiveEngine

    with open(STORE, "rb") as f:
        man, prompts = pickle.load(f)
    store = KVStore()
    store.register(man)
    dev = torch.device("cuda", 0)
    cfg = get_config("lwm-7b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    clock = {"restore": 0.0, "codec": 0.0}
    restore, frames = LiveEngine._restore_chunk, KVCodec.iter_decode_frames

    def timed_restore(eng, *a):
        t0 = time.perf_counter()
        restore(eng, *a)
        clock["restore"] += time.perf_counter() - t0

    def timed_frames(codec, blob):
        it = frames(codec, blob)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            clock["codec"] += time.perf_counter() - t0
            if item is None:
                return
            yield item

    LiveEngine._restore_chunk = timed_restore
    KVCodec.iter_decode_frames = timed_frames
    eng = LiveEngine(params, cfg, store, n_pages=128, device=dev)
    res = {"root": root, "requests": []}
    for prompt in prompts:
        clock.update(restore=0.0, codec=0.0)
        req = eng.submit(prompt, reuse_prefix=man.prefix,
                         reuse_tokens=PREFIX, max_new_tokens=1)
        while req.t_first_token is None:
            eng.step()
        torch.cuda.synchronize()
        res["requests"].append({
            "ttft_s": req.ttft,
            "fetch_s": req.fetch_done - req.fetch_started,
            "restore_host_s": clock["restore"],
            "codec_s": clock["codec"],
            "outside_codec_s": clock["restore"] - clock["codec"]})
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another checkout to time against")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        print(json.dumps(turn(a.turn)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("restore_ab.py: no CUDA device", flush=True)
        return 1
    build_store()
    rc = 0
    for root in (a.other, str(HERE), str(HERE), a.other):
        rc |= subprocess.call([sys.executable, __file__, "--turn", root])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
