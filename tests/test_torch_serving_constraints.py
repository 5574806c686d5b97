"""Steering, stops and scheduling of the port's batcher against the JAX
batcher's, on the same weights (tiny config, 2 KV heads, f32): each script
runs on both, and results, finish reasons, errors, logprobs (within 1e-4)
and host bookkeeping must agree. ``logit_bias`` (ban, force, with top-k),
``allowed_tokens`` (a fixed set, prefix-driven, a grammar, terminal at
admission, terminal mid-decode, raising, out of vocabulary, sampled), the
rest of the JAX package's tests/test_serving_stops.py, and the seeded
solo-oracle schedule of tests/test_serving_fuzz.py:40 through both engines.
Its MoE case waits for MoE."""

import numpy as np
import pytest

from bee_code_interpreter_tpu.models import engine as jax_engine
from bee_code_interpreter_tpu.models import serving as jax_serving
from bee_code_interpreter_tpu_torch.models import engine as torch_engine
from bee_code_interpreter_tpu_torch.models import serving as torch_serving

from tests.torch_parity import batcher_pair, host_state, tiny_configs, tiny_params

PROMPT = [5, 3, 7, 2, 9, 4, 1, 8]
GEOMETRY = dict(max_batch=2, n_pages=32, page_size=4, max_pages_per_seq=8)
MODS = (jax_serving, torch_serving)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    return (jcfg, tcfg, *tiny_params(jcfg, tcfg))


def both(models, script, **kw):
    """``script(batcher, serving module)`` on the JAX batcher and the
    port's; each side's (return value, host state), JAX first."""
    return [(script(b, mod), host_state(b))
            for b, mod in zip(batcher_pair(models, **{**GEOMETRY, **kw}), MODS)]


def outcome(b, r, logprobs=False):
    return (b.result(r), b.finish_reason(r), b.request_error(r),
            b.result_logprobs(r) if logprobs else None)


def assert_same(runs):
    (jout, jstate), (tout, tstate) = runs
    assert tstate == jstate
    for j, t in zip(jout, tout):
        assert t[:3] == j[:3]
        if j[3] is not None:
            np.testing.assert_allclose(t[3], j[3], atol=1e-4)
    return tout


def greedy(models, n):
    def script(b, mod):
        r = b.submit(PROMPT, n)
        b.run_to_completion()
        return b.result(r)

    (want, _), (got, _) = both(models, script)
    assert got == want
    return got


def test_logit_bias_bans_forces_and_composes_with_top_k(models):
    first = greedy(models, 4)[0]

    def script(b, mod):
        reqs = [
            (b.submit(PROMPT, 4, sampling=mod.SamplingParams(
                logit_bias={first: -1e9})), False),
            (b.submit(PROMPT, 4, sampling=mod.SamplingParams(
                logit_bias={7: 1e9}, logprobs=True)), True),
        ]
        b.run_to_completion()
        reqs.append((b.submit(PROMPT, 6, sampling=mod.SamplingParams(
            temperature=0.9, top_k=5, seed=4, logit_bias={first: -1e9, 11: 3.0},
            logprobs=True)), True))
        b.run_to_completion()
        return [outcome(b, r, lp) for r, lp in reqs]

    banned, forced, sampled = assert_same(both(models, script))
    assert first not in banned[0]
    assert forced[0] == [7, 7, 7, 7] and all(lp < -0.5 for lp in forced[3])
    assert first not in sampled[0] and len(sampled[0]) == 6


def test_allowed_tokens_fixed_set_prefixes_and_grammar(models):
    allowed_set = [2, 3, 5, 7, 11, 13]
    A, B = 9, 17

    def alternate(generated):
        if not generated:
            return [A]
        return [B] if generated[-1] == A else [A]

    def script(b, mod):
        seen = []

        def watch(generated):
            seen.append(list(generated))
            return None

        reqs = [b.submit(PROMPT, 6, sampling=mod.SamplingParams(
                    allowed_tokens=lambda g: allowed_set)),
                b.submit(PROMPT, 4, sampling=mod.SamplingParams(
                    allowed_tokens=watch))]
        b.run_to_completion()
        reqs.append(b.submit(PROMPT, 6, sampling=mod.SamplingParams(
            allowed_tokens=alternate)))
        reqs.append(b.submit([3, 1, 4], 8, sampling=mod.SamplingParams(
            temperature=1.5, seed=11, allowed_tokens=lambda g: [1, 2, 3, 4])))
        b.run_to_completion()
        return [outcome(b, r) for r in reqs] + [(seen, None, None, None)]

    fixed, watched, grammar, sampled, seen = assert_same(both(models, script))
    assert all(t in allowed_set for t in fixed[0])
    assert watched[0] == greedy(models, 4)
    assert seen[0] == [watched[0][:i] for i in range(4)]
    assert grammar[0] == [A, B, A, B, A, B]
    assert set(sampled[0]) <= {1, 2, 3, 4} and len(set(sampled[0])) > 1


def test_terminal_raising_and_out_of_vocab_constraints(models):
    A, B = 9, 17

    def three_then_done(generated):
        if len(generated) >= 3:
            return []
        return [A] if len(generated) % 2 == 0 else [B]

    def explode_after_two(generated):
        if len(generated) >= 2:
            raise KeyError("grammar state corrupted")
        return None

    def script(b, mod):
        free0 = len(b.free_pages)
        empty = b.submit(PROMPT, 4, sampling=mod.SamplingParams(
            allowed_tokens=lambda g: [], logprobs=True))
        assert b.is_done(empty) and len(b.free_pages) == free0
        reqs = [(empty, True)]
        for sp in (mod.SamplingParams(allowed_tokens=three_then_done),
                   mod.SamplingParams(allowed_tokens=explode_after_two),
                   mod.SamplingParams(
                       allowed_tokens=lambda g: [10**9] if g else None)):
            reqs.append((b.submit(PROMPT, 10, sampling=sp), False))
            reqs.append((b.submit([3, 1, 4, 1, 5], 6), False))
            b.run_to_completion()
        with pytest.raises(ValueError, match="out-of-vocab"):
            b.submit(PROMPT, 4, sampling=mod.SamplingParams(
                allowed_tokens=lambda g: [-1]))
        return [outcome(b, r, lp) for r, lp in reqs]

    outs = assert_same(both(models, script))
    assert outs[0][:2] == ([], "constraint") and outs[0][3] == []
    assert outs[1][:2] == ([A, B, A], "constraint")
    assert outs[3][1] == "error" and "grammar state corrupted" in outs[3][2]
    assert len(outs[3][0]) == 2
    assert outs[5][1] == "error" and "out-of-vocab" in outs[5][2]
    assert all(o[1] == "length" and len(o[0]) == 6 for o in outs[2::2])


def test_stops_eos_and_logprobs_match_jax(models):
    want = greedy(models, 8)

    def script(b, mod):
        stop_reqs = [
            b.submit(PROMPT, 8, sampling=mod.SamplingParams(
                stop_sequences=((want[2], want[3]),), logprobs=True)),
            b.submit(PROMPT, 8, sampling=mod.SamplingParams(
                stop_sequences=((want[0],),), logprobs=True)),
        ]
        b.run_to_completion()
        sampled = b.submit(PROMPT, 8, sampling=mod.SamplingParams(
            temperature=1.0, top_k=3, seed=2, logprobs=True))
        b.run_to_completion()
        return [outcome(b, r, True) for r in stop_reqs + [sampled]]

    trimmed, empty, sampled = assert_same(both(models, script))
    assert trimmed[:2] == (want[:2], "stop") and len(trimmed[3]) == 2
    assert empty[:2] == ([], "stop") and empty[3] == []
    assert np.isfinite(sampled[3]).all() and len(sampled[3]) == 8

    def eos_script(b, mod):  # eos wins over a stop ending on the same token
        r = b.submit(PROMPT, 8, sampling=mod.SamplingParams(
            stop_sequences=((want[3],),)))
        b.run_to_completion()
        return [outcome(b, r)]

    (out,) = assert_same(both(models, eos_script, eos_id=want[3]))
    assert out[:2] == (want[:4], "eos")


def test_logprob_and_request_errors_match_jax(models):
    def script(b, mod):
        msgs = []
        r_plain = b.submit(PROMPT, 3)
        b.run_to_completion()
        r_lp = b.submit(PROMPT, 3, sampling=mod.SamplingParams(logprobs=True))
        b.run_to_completion()
        b.release(r_lp)
        for call in (lambda: b.result_logprobs(r_plain),
                     lambda: b.result_logprobs(r_lp),
                     lambda: b.result_logprobs(999),
                     lambda: b.cancel(999)):
            with pytest.raises(KeyError) as err:
                call()
            msgs.append(str(err.value))
        with pytest.raises(ValueError, match="non-empty") as err:
            mod.SamplingParams(stop_sequences=((),))
        msgs.append(str(err.value))
        return msgs

    (jmsgs, jstate), (tmsgs, tstate) = both(models, script)
    assert tmsgs == jmsgs and tstate == jstate


def test_cancel_keeps_partial_output_like_jax(models):
    def script(b, mod):
        r_cancel = b.submit(PROMPT, 20)
        r_keep = b.submit([3, 1, 4, 1, 5], 6)
        b.step()
        b.step()
        b.cancel(r_cancel)
        mid = host_state(b)
        r_new = b.submit(PROMPT, 4)
        b.run_to_completion()
        b.cancel(r_keep)  # finished: a no-op
        return [outcome(b, r) for r in (r_cancel, r_keep, r_new)] + [mid]

    (jout, jstate), (tout, tstate) = both(models, script)
    assert tout == jout and tstate == jstate
    assert tout[0][1] == "cancelled" and len(tout[0][0]) == 3
    assert tout[1][1] == "length" and tout[2][0] == greedy(models, 4)


def test_random_schedule_matches_jax_and_the_solo_oracle(models):
    """The seeded fuzz of the JAX package's tests/test_serving_fuzz.py:40,
    one schedule through both engines: every finished ticket equals its
    solo decode and the JAX engine's result, cancelled tickets say so, and
    the pool drains."""
    jcfg, tcfg, jparams, tparams = models
    geometry = dict(max_batch=2, n_pages=16, page_size=4, max_pages_per_seq=4)

    def fuzz(f):
        mod, engine_mod = MODS[f], (jax_engine, torch_engine)[f]
        batcher = batcher_pair(models, **geometry)[f]
        eng = engine_mod.Engine(batcher, max_queue=6)
        rng = np.random.default_rng(20260731)
        live, cancelled, finished = {}, set(), {}
        for _ in range(120):
            op = rng.choice(["submit", "step", "cancel", "step", "step"])
            if op == "submit":
                prompt = [int(x) for x in rng.integers(0, 200, rng.integers(2, 8))]
                n = int(rng.integers(1, 6))
                sampling = None
                if rng.random() < 0.4:
                    sampling = mod.SamplingParams(
                        temperature=0.8, top_k=20, seed=int(rng.integers(1e6)))
                try:
                    t = eng.submit(prompt, n, sampling=sampling,
                                   priority=int(rng.integers(0, 3)))
                except RuntimeError:
                    continue  # queue full: backpressure
                live[t] = (prompt, n, sampling)
            elif op == "cancel" and live and rng.random() < 0.5:
                t = int(rng.choice(list(live)))
                eng.cancel(t)
                cancelled.add(t)
                del live[t]
            else:
                eng.step()
            for t in list(live):
                if eng.is_done(t):
                    finished[t] = live.pop(t)
        eng.run_to_completion()
        finished.update(live)
        return ({t: (eng.result(t), eng.finish_reason(t)) for t in finished},
                {t: eng.finish_reason(t) for t in cancelled},
                eng.stats, finished)

    jres, jcan, jstats, _ = fuzz(0)
    tres, tcan, tstats, finished = fuzz(1)
    assert tres == jres and tcan == jcan and tstats == jstats
    assert len(finished) >= 10
    solo = batcher_pair(models, **{**geometry, "max_batch": 1})[1]
    for t, (prompt, n, sampling) in finished.items():
        r = solo.submit(prompt, n, sampling=sampling)
        solo.run_to_completion()
        assert tres[t] == (solo.result(r), "length"), (t, prompt)
    assert set(tcan.values()) <= {"cancelled"}
    assert tstats["active_rows"] == tstats["queued"] == tstats["held_pages"] == 0
