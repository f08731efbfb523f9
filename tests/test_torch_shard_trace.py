"""The port's ``dist.sharding.shard`` annotations against the reference's:
for each family's smoke config, in train, prefill and decode modes and
with no mesh (``shard`` the identity), the logical axes of every
``shard`` call, in order, recorded by patching ``shard`` where each
module binds it.  The two sequences must be equal, so every annotation
sits at the reference's point of the computation with the reference's
axes.

The reference is traced on abstract values (``jax.eval_shape``) with
``jax.lax.scan`` run as a loop, so its scans over periods and key
chunks call ``shard`` once a layer and a chunk, as the port's loop
does, and nothing is computed.  Its prefill attention
(``chunked_attention``) also annotates its zero accumulator and, inside its loop over key chunks,
each chunk's scores and accumulator; the port's attention is one call
on each rank's local heads (K7 or its plain version), with no global
score or accumulator tensor to annotate, so those three sites are left
out of the reference's sequence and named here.  Its head-major q, k
and v annotations, which set the local call's placement, stay in.  The
microbatch split of the train step (``_split_micro`` against
``train.step.split_micro``) is compared on its own.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.dist import sharding as jax_sharding
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serve.steps import init_cache as jax_init_cache
from repro.train import step as jax_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import registry
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.serve.steps import init_cache
from repro_torch.train import step as torch_step

FAMILIES = ("qwen3-1.7b", "moonshot-v1-16b-a3b", "mixtral-8x7b",
            "jamba-1.5-large-398b", "xlstm-1.3b", "llama-3.2-vision-11b",
            "seamless-m4t-large-v2")
MODES = ("train", "prefill", "decode")
B, S, MAX_SEQ = 2, 8, 16

# the reference's chunked_attention annotations with no port counterpart:
# its scan body's score and accumulator, and its zero accumulator's line
_ACC0_LINE = next(
    i for i, line in enumerate(inspect.getsourcelines(
        JA.chunked_attention)[0], start=JA.chunked_attention.__code__
        .co_firstlineno) if "acc0 = shard(" in line)


def _recorder(log, skip_chunk_internals=False):
    def shard(x, *logical):
        caller = inspect.currentframe().f_back
        internal = caller.f_code is JA.chunked_attention.__code__ and (
            caller.f_lineno == _ACC0_LINE)
        internal |= caller.f_code.co_name == "body" and (
            caller.f_code.co_filename == JA.__file__)
        if not (skip_chunk_internals and internal):
            log.append(tuple(logical))
        return x
    return shard


def _loop_scan(f, init, xs=None, length=None, reverse=False, **_):
    """``jax.lax.scan`` as a Python loop over the leading axis, so a
    trace calls the body (and its ``shard`` calls) once a step."""
    flat, tree = jax.tree.flatten(xs)
    n = length if length is not None else flat[0].shape[0]
    carry, ys = init, []
    for i in (reversed(range(n)) if reverse else range(n)):
        x = None if xs is None else jax.tree.unflatten(
            tree, [a[i] for a in flat])
        carry, y = f(carry, x)
        ys.append(y)
    if reverse:
        ys.reverse()
    if not ys or ys[0] is None:
        return carry, None
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _reference_trace(arch, mode, monkeypatch):
    """The reference's ``shard`` calls while ``forward`` is traced on
    abstract values (``jax.eval_shape``: nothing is computed), its scans
    over periods and key chunks run as loops."""
    cfg = jax_smoke(arch)
    log = []
    rec = _recorder(log, skip_chunk_internals=True)
    for mod in (JL, JA, JT, JM, JS, JX):
        monkeypatch.setattr(mod, "shard", rec)
    monkeypatch.setattr(jax.lax, "scan", _loop_scan)
    params = jax.eval_shape(lambda: jax_step.cast_for_compute(
        jax_step.init_train_state(cfg, jax.random.PRNGKey(0))["params"]))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["memory_embeds"] = jax.ShapeDtypeStruct(
            (B, cfg.num_image_tokens, cfg.d_model), jnp.bfloat16)
    if cfg.family == "encdec":
        kw["memory_embeds"] = jax.ShapeDtypeStruct((B, S, cfg.d_model),
                                                   jnp.bfloat16)

    def run(mode, tokens, cache, kw, index=None):
        return jax.eval_shape(lambda p, t, c, k: JT.forward(
            p, cfg, tokens=t, mode=mode, caches=c, index=index, **k),
            params, tokens, cache, kw)

    if mode == "train":
        run("train", tokens, None, kw)
        return log
    cache = jax.eval_shape(lambda: jax_init_cache(cfg, B, MAX_SEQ))
    if mode == "prefill":
        run("prefill", tokens, cache, kw)
        return log
    # the prefill that fills the cache is not recorded
    _, cache, _ = run("prefill", tokens, cache, kw)
    del log[:]
    run("decode", jax.ShapeDtypeStruct((B, 1), jnp.int32), cache, {},
        index=jnp.array(S, jnp.int32))
    return log


def _port_trace(arch, mode, monkeypatch):
    cfg = get_smoke_config(arch)
    log = []
    rec = _recorder(log)
    for mod in (TL, TA, TT, TM, TS, TX):
        monkeypatch.setattr(mod, "shard", rec)
    params = registry.init_params(cfg, generator=torch.Generator()
                                  .manual_seed(0), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["memory_embeds"] = torch.zeros((B, cfg.num_image_tokens,
                                           cfg.d_model), dtype=torch.bfloat16)
    if cfg.family == "encdec":
        kw["memory_embeds"] = torch.zeros((B, S, cfg.d_model),
                                          dtype=torch.bfloat16)
    with torch.no_grad():
        if mode == "train":
            TT.forward(params, cfg, tokens=tokens, mode="train", **kw)
        else:
            cache = init_cache(cfg, B, MAX_SEQ, device="cpu")
            if mode == "decode":
                log_len = len(log)
                TT.forward(params, cfg, tokens=tokens, mode="prefill",
                           caches=cache, **kw)
                del log[log_len:]
                TT.forward(params, cfg, tokens=tokens[:, :1], mode="decode",
                           index=S, caches=cache)
            else:
                TT.forward(params, cfg, tokens=tokens, mode="prefill",
                           caches=cache, **kw)
    return log


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_calls_match_reference(arch, mode, monkeypatch):
    want = _reference_trace(arch, mode, monkeypatch)
    got = _port_trace(arch, mode, monkeypatch)
    assert want, "the reference made no shard call"
    assert got == want, next(
        (i, g, w) for i, (g, w) in enumerate(zip(got + [None] * len(want),
                                                 want + [None] * len(got)))
        if g != w)


def test_microbatch_split_matches_reference(monkeypatch):
    """``split_micro``: the reference's reshape to [n, B/n, ...] and its
    ("batch" on dim 1) annotation, leaf by leaf in the same order, and
    the same rows in each microbatch."""
    jlog, tlog = [], []
    monkeypatch.setattr(jax_sharding, "shard", _recorder(jlog))
    monkeypatch.setattr(torch_step, "shard", _recorder(tlog))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (4, 8)).astype(np.int32),
             "targets": rng.integers(0, 256, (4, 8)).astype(np.int32),
             "frames": rng.normal(size=(4, 8, 16)).astype(np.float32)}
    want = jax_step._split_micro({k: jnp.asarray(v)
                                  for k, v in batch.items()}, 2)
    got = torch_step.split_micro({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, 2)
    assert tlog == jlog and len(jlog) == 3
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
