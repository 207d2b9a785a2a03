"""The port's host-side serving bookkeeping against the JAX package's:
``BlockLedger`` (with its ``BlockPool`` and prefix index) driven through
the same random scripts of admissions, prefix matches, copy-on-write forks,
speculative windows and releases must make the same decisions — the same
chains, spares, lengths, counters and free lists after every step — and
the scheduler must admit the same requests into the same slots.  Both are
pure Python; the outputs are compared exactly."""
import numpy as np
import pytest

from repro.serving import kvcache as jkv
from repro.serving import scheduler as jsched
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import scheduler as tsched


def _view(led):
    p = led.pool
    return (led.chains, led.spares, led.lens, led.hits, led.misses,
            led.cached_tokens, led.cow_forks, led.spec_rollback_tokens,
            led.spec_fork_undos, list(p._free), dict(p._ref), list(p._lru),
            p.n_cache_evictions,
            sorted(led.index.items()) if led.index is not None else None)


def _script(seed, leds, n_slots, bs, nblk, steps=120):
    """Random ledger operations, applied to every ledger in ``leds``;
    prompts share prefixes so matches, COW forks and reclaims happen."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 50, 4 * bs).astype(np.int32)
    open_spec = [False] * n_slots
    for _ in range(steps):
        slot = int(rng.randint(n_slots))
        busy = bool(leds[0].chains[slot])
        act = rng.randint(6)
        if not busy:
            n = int(rng.randint(1, 3 * bs))
            prompt = np.concatenate(
                [base[:int(rng.randint(0, 3 * bs))],
                 rng.randint(0, 50, n).astype(np.int32)])[:nblk * bs - 4]
            if prompt.size == 0:
                continue
            reserve = min(nblk * bs, int(prompt.size) + int(rng.randint(1, 5)))
            out = []
            for led in leds:
                m = led.match_and_lock(prompt)
                need = led.fresh_blocks_needed(reserve, m)
                if need > led.pool.free_blocks:
                    if m is not None:
                        led.unlock(m)
                    out.append(None)
                    continue
                out.append(led.admit(slot, prompt, reserve, match=m))
                if m is None:
                    led.register_prompt(slot)
            assert all(o == out[0] for o in out)
            continue
        cap = len(leds[0].chains[slot]) * bs
        if act == 0:                              # finish
            for led in leds:
                led.release(slot)
            open_spec[slot] = False
        elif act == 1 and not open_spec[slot]:    # open a window
            for led in leds:
                led.spec_begin(slot)
            open_spec[slot] = True
        elif act == 2 and open_spec[slot]:        # close it
            written = leds[0].lens[slot] - leds[0]._spec_base[slot]
            keep = int(rng.randint(0, written + 1))
            assert len({led.spec_commit(slot, keep) for led in leds}) == 1
            open_spec[slot] = False
        elif leds[0].lens[slot] < cap:            # one decode write
            forks = [led.fork(slot) if led.needs_fork(slot) else None
                     for led in leds]
            assert all(f == forks[0] for f in forks)
            for led in leds:
                led.note_write(slot, 1)
        views = [_view(led) for led in leds]
        assert all(v == views[0] for v in views)
        for led in leds:
            led.check()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_ledger_decisions_match_jax(seed, prefix_cache):
    n_slots, bs, nblk = 3, 4, 6
    nb = 1 + n_slots * nblk - 4               # a tight pool: reclaims
    leds = [mod.BlockLedger(nb, n_slots, bs, nblk, prefix_cache=prefix_cache)
            for mod in (jkv, tkv)]
    _script(seed, leds, n_slots, bs, nblk)


def test_ledger_spec_rollback_undoes_fork_like_jax():
    """The case of tests/test_speculation.py, step by step on both."""
    leds = []
    for mod in (jkv, tkv):
        led = mod.BlockLedger(20, 3, 4, 4, prefix_cache=True)
        p = np.arange(1, 8, dtype=np.int32)
        led.admit(0, p, 11)
        led.register_prompt(0)
        led.release(0)
        for slot in (1, 2):
            m = led.match_and_lock(p)
            assert m.covered == 6 and m.needs_cow_spare
            led.admit(slot, p, 11, match=m)
        led.spec_begin(1)
        ci, old, new = led.fork(1)
        led.note_write(1, 2)
        assert led.spec_commit(1, 0) == 2
        assert led.chains[1][ci] == old and led.spares[1] == new
        led.check()
        leds.append(led)
    assert _view(leds[0]) == _view(leds[1])


def test_scheduler_admits_like_jax():
    """Admission control over a tight pool: the same requests into the
    same slots, tick by tick, with the same refill counters."""
    reqs = tsched.synthetic_requests(9, 100, prompt_len=20,
                                     max_new_tokens=6, seed=2)
    runs = []
    for kv, sc in ((jkv, jsched), (tkv, tsched)):
        pool = kv.BlockPool(12)
        s = sc.Scheduler(3, 8, pool, max_seq_len=32, clock=lambda: 0.0)
        for r in reqs:
            s.submit(sc.Request(r.rid, r.prompt, r.max_new_tokens))
        held, log = {}, []
        while s.has_work():
            adm = s.admissions()
            for a in adm:
                held[a.slot] = pool.allocate(
                    kv.blocks_for_tokens(a.reserve_tokens, 8))
                s.record_token(a.slot, 1, first=True)
            for i in s.active_slots:
                s.record_token(i, 2)
            for i in s.finished():
                s.evict(i)
                pool.release(held.pop(i))
            log.append([(a.slot, a.request.rid) for a in adm])
        runs.append((log, s.n_admitted, s.n_refills, s.n_evicted))
    assert runs[0] == runs[1] and runs[1][1] == 9 and runs[1][2] > 0


def test_request_sources_match_jax(tmp_path):
    for fn in ("synthetic_requests", "shared_prefix_requests"):
        a = getattr(jsched, fn)(4, 300, seed=7)
        b = getattr(tsched, fn)(4, 300, seed=7)
        assert [(r.rid, r.prompt.tolist(), r.max_new_tokens) for r in a] == \
            [(r.rid, r.prompt.tolist(), r.max_new_tokens) for r in b]
    path = tmp_path / "reqs.jsonl"
    path.write_text('{"id": "x", "prompt": [1, 2, 3], "max_new_tokens": 4}\n'
                    '{"prompt_len": 5, "seed": 3, "stop_token": 9}\n')
    a = jsched.load_requests_jsonl(str(path), 50)
    b = tsched.load_requests_jsonl(str(path), 50)
    assert [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.stop_token)
            for r in a] == [(r.rid, r.prompt.tolist(), r.max_new_tokens,
                             r.stop_token) for r in b]
