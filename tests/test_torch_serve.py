"""The port's serve entry point on the CPU: ``repro_torch.launch.serve``'s
live scenario (the scenario of examples/serve_reuse.py) on weights
bridged from the JAX init, held against the JAX ``LiveEngine`` serving
the same prompts from the same donor KV; and the command line, whose
``--simulate`` prints what the JAX launcher prints."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.cluster.network import BandwidthTrace  # noqa: E402
from repro.cluster.storage import KVStore as JaxKVStore  # noqa: E402
from repro.serving.engine import LiveEngine as JaxLiveEngine  # noqa: E402
from repro.serving.metrics import split_summary  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402


def test_live_scenario_matches_jax_engine(tiny_cfg, tiny_params):
    params = from_numpy(jax.tree.map(np.asarray, tiny_params), tiny_cfg,
                        device="cpu")
    lines = []
    got = serve.live_scenario(params, tiny_cfg, device="cpu",
                              log=lines.append)
    assert any("streamed" in s for s in lines)

    store = JaxKVStore()
    store.register_prefix(got["prefix"], got["kv_k"], got["kv_v"],
                          tokens_per_chunk=serve.TOKENS_PER_CHUNK,
                          resolutions=serve.RESOLUTIONS)
    reuse = dict(reuse_prefix=got["key"], reuse_tokens=serve.PREFIX_LEN,
                 max_new_tokens=serve.NEW_TOKENS)
    eng = JaxLiveEngine(tiny_params, tiny_cfg, store, policy="kvfetcher",
                        max_running=4)
    reqs = [eng.submit(p, **reuse) for p in got["prompts"]]
    reqs.append(eng.submit(got["plain_prompt"],
                           max_new_tokens=serve.NEW_TOKENS))
    eng.run()
    assert got["outputs"] == [eng.outputs[r.rid] for r in reqs]
    summary = split_summary(eng.finished)
    assert {k: s["n"] for k, s in got["summary"].items()} == \
        {k: s["n"] for k, s in summary.items()} == \
        {"all": 4.0, "fetching": 3.0, "non_reuse": 1.0}

    ref = JaxLiveEngine(tiny_params, tiny_cfg, JaxKVStore(), max_running=4)
    r = ref.submit(got["prompts"][0], max_new_tokens=serve.NEW_TOKENS)
    ref.run()
    assert got["full_prefill"] == ref.outputs[r.rid]

    eng_s = JaxLiveEngine(tiny_params, tiny_cfg, store, policy="kvfetcher",
                          fetch_mode="async",
                          bandwidth=BandwidthTrace.constant(serve.WAN_GBPS))
    s = eng_s.submit(got["prompts"][0], **reuse)
    eng_s.run()
    assert got["stream"] == eng_s.outputs[s.rid]
    assert got["stream_times"] == s.token_times


#: (method, chip) of each --simulate case: every method, every chip
SIMULATE_CASES = [("kvfetcher", "h20"), ("cachegen", "a100"),
                  ("llm265", "l20"), ("raw", "tpu-v5e"),
                  ("lmcache_raw", "h20"), ("full_prefill", "a100")]


@pytest.mark.parametrize("method,chip", SIMULATE_CASES)
def test_command_line(method, chip, capsys, monkeypatch):
    """``--simulate`` prints what the JAX launcher prints for the same
    arguments."""
    from repro.launch import serve as jax_serve

    argv = ["--simulate", "--method", method, "--arch", "yi-34b",
            "--gbps", "8", "--context", "60000", "--requests", "3",
            "--chip", chip]
    serve.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve.py"] + argv)
    jax_serve.main()
    want = capsys.readouterr().out
    assert got == want
    assert got.startswith(f"method={method} ctx=60000 bw=8.0Gbps")
    assert "ttft_mean" in got


def test_command_line_live(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--live", "--reduced"])
    serve.main(["--live", "--reduced", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "streamed 4 tokens" in out and out.rstrip().endswith("OK")


def test_command_line_live_moe(capsys):
    """``--live`` serves a reduced MoE decoder; an encoder is refused."""
    serve.main(["--live", "--reduced", "--arch", "deepseek-moe-16b",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("deepseek-moe-16b-smoke: random weights")
    assert "streamed 4 tokens" in out and out.rstrip().endswith("OK")
    with pytest.raises(SystemExit):
        serve.main(["--live", "--reduced", "--arch", "hubert-xlarge",
                    "--device", "cpu"])
    assert "all attention" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "recurrentgemma-9b"])
def test_command_line_simulate_zoo(arch, capsys, monkeypatch):
    """``--simulate`` takes every registered arch, as the JAX launcher
    does, and prints what it prints."""
    from repro.launch import serve as jax_serve

    argv = ["--simulate", "--arch", arch, "--context", "30000",
            "--requests", "2"]
    serve.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["serve.py"] + argv)
    jax_serve.main()
    assert got == capsys.readouterr().out
    assert "ttft_mean" in got
