"""The port's optimizers and schedule (``repro_torch.optim``) against the
reference's (``repro.optim``) on the same numpy-seeded trees: AdamW and
Adafactor after 1 and 3 updates, factored and unfactored leaves, an
Adafactor bf16 master, the stacking groups of Adafactor's RMS, global-norm
clipping and the warm-up cosine schedule.

Tolerance: 1e-6 relative to each leaf's largest value (the same f32
expressions per element; XLA and PyTorch reduce the means and norms in
other orders).  The global norm and the clipped gradients within four
f32 steps (2^-22 relative): the two sums of squares, reduced in other
orders, land one or two f32 steps apart.  The schedule within 1e-7 of
its peak: the f32 cosines of XLA and PyTorch differ by one step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro_torch.common.pytree import ParamDef, tree_leaves
from repro_torch.optim import (
    adafactor,
    adamw,
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    opt_state_defs,
    warmup_cosine,
)

F32_STEPS = 2.0 ** -22      # four f32 steps, relative
# factored ([4, 6], [3, 5, 7]) and unfactored ([5], [1, 8], [6, 1]) leaves
SHAPES = {"w": (4, 6), "stack": {"u": (3, 5, 7), "b": (5,)},
          "row": (1, 8), "col": (6, 1)}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                        tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got, want, rtol=1e-6):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * max(np.abs(w).max(), 1e-30), (
            np.abs(g - w).max(), np.abs(w).max())


def _run(make_jax, make_torch, n_updates, dtype_j=jnp.float32,
         dtype_t=torch.float32):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, 0.1) for _ in range(n_updates)]
    jopt, topt = make_jax(), make_torch()
    jp, tp = _jax(params, dtype_j), _torch(params, dtype_t)
    js, ts = jopt.init(jp), topt.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js = jopt.update(_jax(g), js, jp, jnp.float32(lr),
                             jnp.int32(i))
        tp, ts = topt.update(_torch(g), ts, tp,
                             torch.tensor(lr, dtype=torch.float32),
                             torch.tensor(i, dtype=torch.int32))
    return jp, js, tp, ts


@pytest.mark.parametrize("n_updates", (1, 3))
@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_optimizer_matches_reference(name, n_updates):
    mk = {"adamw": (jax_adamw, adamw), "adafactor": (jax_adafactor,
                                                     adafactor)}[name]
    jp, js, tp, ts = _run(*mk, n_updates)
    _close(tp, jp)
    _close(ts, js)


@pytest.mark.parametrize("n_updates", (1, 3))
def test_adafactor_bf16_master_matches_reference(n_updates):
    """bf16 master weights: the update in f32, rounded once to bf16, so
    the two land on the same bf16 value."""
    jp, js, tp, ts = _run(jax_adafactor, adafactor, n_updates,
                          jnp.bfloat16, torch.bfloat16)
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    _close(ts, js)


@pytest.mark.parametrize("shape", ((3, 5, 7), (3, 7)))
def test_adafactor_groups_share_the_stacked_leaf_rms(shape):
    """A leaf the reference stacks over 3 periods [3, 5, 7] is three
    per-layer [5, 7] leaves in the port; with ``group_of`` putting them
    in one group their update clip and relative step are the stacked
    leaf's.  Stacked [3, 7] (per-layer 1-D leaves) the reference factors
    the second moment over the layers, and so does the port."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=shape).astype(np.float32)
    grads = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jopt = jax_adafactor()
    jp = {"w": jnp.asarray(p)}
    js = jopt.init(jp)
    topt = adafactor(group_of=lambda path: path[:1])
    tp = {"w": [torch.from_numpy(p[i].copy()) for i in range(3)]}
    ts = topt.init(tp)
    for i, g in enumerate(grads):
        jp, js = jopt.update({"w": jnp.asarray(g)}, js, jp,
                             jnp.float32(0.1), jnp.int32(i))
        tp, ts = topt.update({"w": [torch.from_numpy(g[j].copy())
                                    for j in range(3)]}, ts, tp,
                             torch.tensor(0.1), torch.tensor(i))
    got = torch.stack(tp["w"]).numpy()
    want = np.asarray(jp["w"])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if len(shape) == 2:
        assert [set(s) for s in ts["f"]["w"]] == [{"vr", "vc"}, {"vr"},
                                                  {"vr"}]
        np.testing.assert_allclose(
            torch.stack([s["vr"] for s in ts["f"]["w"]]).numpy(),
            np.asarray(js["f"]["w"]["vr"]), rtol=1e-6)
        np.testing.assert_allclose(ts["f"]["w"][0]["vc"].numpy(),
                                   np.asarray(js["f"]["w"]["vc"]), rtol=1e-6)


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(2)
    for scale in (0.01, 10.0):
        g = _tree(rng, SHAPES, scale)
        jg, jn = jax_clip(_jax(g), 1.0)
        tg, tn = clip_by_global_norm(_torch(g), 1.0)
        assert abs(float(tn) - float(jn)) <= F32_STEPS * float(jn)
        assert float(global_norm(_torch(g))) == float(tn)
        _close(tg, jg, rtol=F32_STEPS)


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-4, warmup=10, total=50)
    for step in range(0, 60):
        want = float(jax_warmup_cosine(jnp.int32(step), **kw))
        got_t = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got_t.dtype == torch.float32
        assert abs(float(got_t) - want) <= 1e-7 * kw["peak_lr"]
        assert abs(warmup_cosine(step, **kw) - want) <= 1e-7 * kw["peak_lr"]


def test_state_defs_and_names():
    defs = {"w": ParamDef((4, 6), torch.bfloat16, ("fsdp", "tp")),
            "b": ParamDef((6,), torch.float32, ("tp",))}
    f32 = torch.float32
    assert opt_state_defs("adamw", defs)["m"]["w"] == ParamDef(
        (4, 6), f32, ("fsdp", "tp"), "zeros")
    f = opt_state_defs("adafactor", defs)["f"]
    assert f["w"] == {"vr": ParamDef((4,), f32, ("fsdp",), "zeros"),
                      "vc": ParamDef((6,), f32, ("tp",), "zeros")}
    assert f["b"] == {"v": ParamDef((6,), f32, ("tp",), "zeros")}
    assert get_optimizer("adamw").name == "adamw"
    with pytest.raises(ValueError):
        get_optimizer("sgd")


def test_adafactor_state_carries_across_from_the_reference():
    """Jamba's smoke config under Adafactor (two periods, so its per-layer
    1-D leaves stack to factored [2, d] leaves in the reference): a state
    in the reference's layout (zeros on its ``train_state_defs``, as its
    ``init_train_state`` makes the moments) carried across by
    ``convert.train_state_from_reference`` has the port's layout, leaf for
    leaf, and the port's ``train_state_defs`` describe it."""
    import dataclasses

    from repro.common.pytree import is_def
    from repro.configs import get_smoke_config as jax_smoke
    from repro.train.step import train_state_defs as jax_state_defs
    from repro_torch import convert
    from repro_torch.common.pytree import tree_paths
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import init_train_state, train_state_defs

    kw = dict(optimizer="adafactor", master_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke("jamba-1.5-large-398b"), **kw)
    cfg = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"), **kw)
    carried = convert.train_state_from_reference(
        jax.tree.map(lambda d: np.zeros(d.shape, jnp.dtype(d.dtype)),
                     jax_state_defs(jcfg), is_leaf=is_def), device="cpu")
    ours = init_train_state(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    defs = train_state_defs(cfg)
    assert tree_paths(carried["opt"]) == tree_paths(ours["opt"]) == \
        tree_paths(defs["opt"])
    paths = set(tree_paths(ours["opt"]))
    P = len(ours["params"]["layers"]) // 2      # layers a period
    ln1 = ("f", "layers", 0, "ln1", "scale")
    assert {ln1 + ("vr",), ln1 + ("vc",)} <= paths
    later = ("f", "layers", P, "ln1", "scale")
    assert later + ("vr",) in paths and later + ("vc",) not in paths
    for a, b, d in zip(tree_leaves(carried["opt"]), tree_leaves(ours["opt"]),
                       tree_leaves(defs["opt"])):
        assert a.shape == b.shape == d.shape and a.dtype == b.dtype
        assert not a.any()
