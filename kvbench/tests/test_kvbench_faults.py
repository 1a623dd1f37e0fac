"""The check fails a run whose timed path is broken underneath: the rest
of a run (on the CPU, without the look for a card) with one fault
planted in the program, each of the faults a one-chip serving cell can
have, and the sound run beside them."""
import contextlib

import pytest

from kvbench.tests import tiny


@contextlib.contextmanager
def patched(owner, attr, make):
    old = getattr(owner, attr)
    setattr(owner, attr, make(old))
    try:
        yield
    finally:
        setattr(owner, attr, old)


def decode_module():
    from repro_torch.serving import paged_model
    return paged_model


def cache_class():
    from repro_torch.paged.cache import PagedKVCache
    return PagedKVCache


def token_altered():
    """A served token changed where the decode step produces it."""
    def make(decode):
        def bad(*a, **k):
            logits = decode(*a, **k)
            top = logits.argmax(-1)
            logits[0, (top[0] + 1) % logits.shape[-1]] = logits[0].max() + 1
            return logits
        return bad
    return patched(decode_module(), "decode_paged", make)


def state_unchanged():
    """A decode step that leaves the paged KV as it was (the new token's
    K and V are never written)."""
    return patched(cache_class(), "write_rows",
                   lambda f: lambda self, *a, **k: None)


def restore_skipped():
    """A fetch that leaves the pages as they were (no chunk restored)."""
    return patched(cache_class(), "restore_chunk",
                   lambda f: lambda self, *a, **k: None)


def half_batch():
    """Half of a decode batch left out: its sequences take the logits of
    the other half."""
    def make(decode):
        def bad(params, cfg, tokens, positions, cache, seq_ids):
            logits = decode(params, cfg, tokens, positions, cache, seq_ids)
            h = (len(seq_ids) + 1) // 2
            if len(seq_ids) > 1:
                logits[h:] = logits[:len(seq_ids) - h]
            return logits
        return bad
    return patched(decode_module(), "decode_paged", make)


CASES = [("sound", None, tiny.CHAT), ("token_altered", token_altered,
                                      tiny.CHAT),
         ("state_unchanged", state_unchanged, tiny.CHAT),
         ("half_batch", half_batch, tiny.CHAT),
         ("restore_skipped", restore_skipped, tiny.REUSE)]


@pytest.mark.parametrize("name,fault,mix", CASES, ids=[c[0] for c in CASES])
def test_the_check_fails_a_broken_path(name, fault, mix, tmp_path):
    bench = tiny.write(tmp_path, tiny.DENSE, mix)
    with fault() if fault else contextlib.nullcontext():
        res = tiny.run(tmp_path, bench, seed=5, seconds=0.6)
    gap = res["compared"]["served_gap"]["value"]
    if fault is None:
        assert res["correct"] is True and gap == 0.0
    else:
        assert res["correct"] is False and gap > 1e-3, gap
