"""The port's LM ``ServeEngine`` against the reference's on CPU tensors:
the same f32 weights (carried across by ``lm_params_from_reference``),
the same requests with mixed prompt lengths (so left-padding shows) and
``batch_slots=2``, served by both engines; every request's tokens must
be identical and the ``requests``/``tokens`` stats equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.common import pytree as pt
from repro.configs import get_smoke_config
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.step import init_train_state
from repro_torch import configs, convert
from repro_torch.serve.engine import Request, ServeEngine

# (prompt length, max_new_tokens): two lockstep batches of two, the
# second with unequal budgets
REQUESTS = ((5, 6), (9, 6), (3, 4), (7, 8), (6, 5))


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    return [cls(rid=i, prompt=rng.integers(1, vocab, n).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(REQUESTS)]


def _serve(engine, reqs, max_steps):
    for r in reqs:
        engine.submit(r)
    return engine.run(max_steps=max_steps)


@pytest.fixture(scope="module")
def reference_runs():
    """name -> (f32 reference params, reference requests, stats), each
    reference engine run once for the module."""
    out = {}
    for name in ("qwen3-1.7b", "qwen1.5-32b"):
        cfg = get_smoke_config(name)
        params = pt.cast_floating(
            init_train_state(cfg, jax.random.PRNGKey(5))["params"],
            jnp.float32)
        reqs = _requests(JaxRequest, cfg.vocab_size)
        stats = _serve(JaxServeEngine(cfg, params, batch_slots=2,
                                      max_seq=32), reqs, 64)
        out[name] = (params, reqs, stats)
    return out


@pytest.mark.parametrize("name", ("qwen3-1.7b", "qwen1.5-32b"))
@pytest.mark.parametrize("backend", ("cuda", "interpret"))
def test_engine_serves_the_references_tokens(reference_runs, name, backend):
    params, jreqs, jstats = reference_runs[name]
    cfg = get_smoke_config(name)
    ours = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    eng = ServeEngine(cfg, ours, batch_slots=2, max_seq=32, backend=backend,
                      device="cpu")
    assert eng.backend == ("cpu-ref" if backend == "cuda" else "interpret")
    reqs = _requests(Request, cfg.vocab_size)
    stats = _serve(eng, reqs, 64)
    assert set(stats) == set(jstats)
    assert (stats["requests"], stats["tokens"]) == (jstats["requests"],
                                                    jstats["tokens"])
    for a, b in zip(reqs, jreqs):
        assert a.done and a.out == b.out, (a.rid, a.out, b.out)
    # lockstep batches of 2: three prefills; each decodes its longest
    # budget
    assert eng.timing["prefill_calls"] == 3
    assert eng.timing["decode_calls"] == 6 + 8 + 5


def test_step_budget_and_a_lone_request_follow_the_reference(
        reference_runs):
    """``max_steps`` cuts the lockstep loop where the reference's does
    (the rest stays queued), and a lone request, whose batch-mate row is
    all padding, gets the reference's tokens."""
    params, _, _ = reference_runs["qwen3-1.7b"]
    cfg = get_smoke_config("qwen3-1.7b")
    ours = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), device="cpu")
    for max_steps, picked in ((9, slice(None)), (64, slice(1, 2))):
        jeng = JaxServeEngine(cfg, params, batch_slots=2, max_seq=32)
        eng = ServeEngine(cfg, ours, batch_slots=2, max_seq=32,
                          device="cpu")
        jreqs = _requests(JaxRequest, cfg.vocab_size)[picked]
        reqs = _requests(Request, cfg.vocab_size)[picked]
        jstats = _serve(jeng, jreqs, max_steps)
        stats = _serve(eng, reqs, max_steps)
        assert (stats["requests"], stats["tokens"]) == (jstats["requests"],
                                                        jstats["tokens"])
        assert [r.out for r in reqs] == [r.out for r in jreqs]
        assert [r.rid for r in eng.queue] == [r.rid for r in jeng.queue]


def test_engine_refuses_unknown_backends_and_families():
    cfg = configs.get_smoke_config("qwen3-1.7b")
    with pytest.raises(KeyError, match="backend"):
        ServeEngine(cfg, {}, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="diffusion"):
        ServeEngine(dataclasses.replace(cfg, family="diffusion"), {},
                    device="cpu")
