"""The port's schedules and optimizer against the JAX package's (optax).

Schedules: every name ``train/schedulers.get_scheduler`` takes, value by
value over a whole run and a little past its end, rtol 1e-5 / atol 1e-10
(fp32 on both sides). Optimizer: three steps of
``train/optim.make_clip_optimizer`` on a small tree that has a leaf in each
of the four groups, gradients from a numpy seed and large enough that both
video groups clip, each by its own norm; updates agree to rtol 2e-5 /
atol 1e-9 (the port writes the moment updates as ``m + (1-b)(g - m)``).
RAdam runs nine steps, past the sixth where its rectification starts, at
rtol 2e-2: optax takes the rectification term, a small difference of
numbers near 2000, in fp32, which leaves it about two digits in those
steps; the port takes it in fp64, and is held to the formula in float64 at
rtol 2e-5 by ``test_radam_matches_its_formula_in_float64``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.train import optim as joptim
from deepcoro_clip_tpu.train import schedulers as jsched

from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.train import optim as toptim
from deepcoro_clip_tpu_torch.train import schedulers as tsched

NAMES = ["cosine", "step", "cosine_warm_restart", "linear_warmup",
         "cosine_with_warmup", "cosine_with_hard_restarts_with_warmup"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("accum", [1, 2])
def test_schedule_matches_optax_value_by_value(name, accum):
    kw = dict(num_warmup_percent=0.1, factor=0.3, lr_step_period=2,
              num_hard_restarts_cycles=3.0, warm_restart_tmult=2,
              gradient_accumulation_steps=accum)
    ref = jsched.get_scheduler(name, 3e-4, 13, 7, **kw)
    got = tsched.get_scheduler(name, 3e-4, 13, 7, **kw)
    total = (13 // accum) * 7
    steps = np.arange(total + 5)
    want = np.array([float(ref(jnp.int32(i))) for i in steps])
    have = np.array([float(got(int(i))) for i in steps])
    np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-10)
    # a count that lives in a tensor gives the same value, as a tensor
    t = got(torch.tensor(5, dtype=torch.int64))
    assert isinstance(t, torch.Tensor) and float(t) == pytest.approx(have[5], rel=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler_name"):
        tsched.get_scheduler("nope", 1e-3, 10, 1)


# --------------------------------------------------------------------------- #
# optimizer

SHAPES = {
    "video_encoder/backbone/block0/attn/qkv/kernel": (8, 24),
    "video_encoder/backbone/norm/scale": (8,),
    "video_encoder/backbone/pool1/kernel": (8, 8),
    "video_encoder/aggregator/query": (8,),
    "text_encoder/layer0/output/kernel": (16, 8),
    "text_encoder/proj/proj/bias": (8,),
    "log_temp": (),
    "logit_bias": (),
}


def _nested(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("optimizer", ["AdamW", "adam", "radam", "sgd"])
def test_three_optimizer_steps_match_optax(optimizer):
    kw = dict(optimizer=optimizer, lr=1e-3, text_lr=2e-4, video_weight_decay=0.1,
              text_weight_decay=0.05, max_grad_norm=1.0, text_max_grad_norm=0.5)
    jcfg, tcfg = jax_tiny(**kw), tiny_config(**kw)
    r = np.random.default_rng(0)
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (r.normal(size=s) * 3).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    sched_kw = dict(num_warmup_percent=0.25)
    jtx = joptim.make_clip_optimizer(
        jcfg, jsched.get_scheduler("cosine_with_warmup", 1e-3, 8, 2, **sched_kw),
        _nested({k: jnp.asarray(v) for k, v in p0.items()}))
    jparams = _nested({k: jnp.asarray(v) for k, v in p0.items()})
    jstate = jtx.init(jparams)

    tparams = {k.replace("/", "."): torch.tensor(v) for k, v in p0.items()}
    ttx = toptim.make_clip_optimizer(
        tcfg, tsched.get_scheduler("cosine_with_warmup", 1e-3, 8, 2, **sched_kw), tparams)
    tstate = ttx.init(tparams)
    assert toptim.group_label("video_encoder.backbone.pool1.weight") == "video_2x"
    assert toptim.group_label("video_encoder.backbone.patch_embed.conv.kernel") == "video"

    rtol = 2e-2 if optimizer == "radam" else 2e-5
    gate = torch.tensor(1.0)
    for g in grads * (3 if optimizer == "radam" else 1):  # radam rectifies from step 6
        jup, jstate = jtx.update(_nested({k: jnp.asarray(v) for k, v in g.items()}),
                                 jstate, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup = ttx.update({k.replace("/", "."): torch.tensor(v) for k, v in g.items()},
                         tstate, tparams, gate)
        for k, u in _flat(jup).items():
            np.testing.assert_allclose(tup[k.replace("/", ".")].numpy(), np.asarray(u),
                                       rtol=rtol, atol=1e-9, err_msg=k)
        for k, u in tup.items():
            tparams[k].add_(u)
    steps = int(tstate["count"])
    assert steps == (9 if optimizer == "radam" else 3)
    for k, v in _flat(jparams).items():
        np.testing.assert_allclose(tparams[k.replace("/", ".")].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-5 if optimizer == "radam" else 1e-7,
                                   err_msg=k)
    if optimizer == "sgd":
        return
    # a closed gate (a non-finite loss) moves nothing, also behind the
    # largest gradients nan_to_num can leave (their squares overflow)
    before = {k: v.clone() for k, v in tstate["mu"].items()}
    before_nu = {k: v.clone() for k, v in tstate["nu"].items()}
    huge = torch.finfo(torch.float32).max
    for scale in (1.0, huge):
        up = ttx.update({k.replace("/", "."): torch.tensor(v).sign() * scale
                         if scale == huge else torch.tensor(v)
                         for k, v in grads[0].items()},
                        tstate, tparams, torch.tensor(0.0))
        assert all(float(u.abs().max()) == 0.0 for u in up.values())
        assert all(torch.equal(tstate["mu"][k], before[k]) for k in before)
        assert all(torch.equal(tstate["nu"][k], before_nu[k]) for k in before_nu)
        assert int(tstate["count"]) == steps


def test_radam_matches_its_formula_in_float64():
    """optax's own RAdam (``optax.radam``, behind the JAX package's
    ``make_clip_optimizer``) leaves about two digits once it rectifies (see
    the module note), so the port's RAdam is held beside it to the formula
    itself (Liu et al. 2020, as ``optax.scale_by_radam`` writes it, threshold
    5) in float64 numpy: nine steps, each update to rtol 2e-5 / atol 1e-9.
    Groups, rate scales and clip norms are the port's, which the other
    optimizers hold against optax."""
    kw = dict(optimizer="radam", lr=1e-3, text_lr=2e-4, video_weight_decay=0.1,
              text_weight_decay=0.05, max_grad_norm=1.0, text_max_grad_norm=0.5)
    r = np.random.default_rng(0)
    names = [k.replace("/", ".") for k in SHAPES]
    shapes = dict(zip(names, SHAPES.values()))
    tparams = {k: torch.tensor(r.normal(size=s).astype(np.float32))
               for k, s in shapes.items()}
    grads = [{k: (r.normal(size=s) * 3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(9)]
    ttx = toptim.make_clip_optimizer(
        tiny_config(**kw),
        tsched.get_scheduler("cosine_with_warmup", 1e-3, 8, 2, num_warmup_percent=0.25),
        tparams)
    tstate = ttx.init(tparams)
    b1, b2, eps = 0.9, 0.999, 1e-8
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    mu = {k: np.zeros(s) for k, s in shapes.items()}
    nu = {k: np.zeros(s) for k, s in shapes.items()}
    rectified = 0
    for t, g in enumerate(grads, 1):
        lr = float(ttx.schedule(t - 1))
        got = ttx.update({k: torch.tensor(v) for k, v in g.items()}, tstate, tparams,
                         torch.tensor(1.0))
        ro = ro_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        rectified += ro >= 5.0
        for label, members in ttx.groups.items():
            scale, _, clip = ttx.hyper[label]
            gs = {k: g[k].astype(np.float64) for k in members}
            if clip:
                norm = np.sqrt(sum(float((x ** 2).sum()) for x in gs.values()))
                gs = {k: x * min(1.0, clip / norm) for k, x in gs.items()}
            for k, x in gs.items():
                mu[k] = b1 * mu[k] + (1 - b1) * x
                nu[k] = b2 * nu[k] + (1 - b2) * x * x
                m_hat, n_hat = mu[k] / (1 - b1 ** t), nu[k] / (1 - b2 ** t)
                if ro >= 5.0:
                    rect = np.sqrt((ro - 4) * (ro - 2) * ro_inf
                                   / ((ro_inf - 4) * (ro_inf - 2) * ro))
                    u = rect * m_hat / (np.sqrt(n_hat) + eps)
                else:
                    u = m_hat
                np.testing.assert_allclose(got[k].numpy(), -lr * scale * u,
                                           rtol=2e-5, atol=1e-9, err_msg=f"{k} step {t}")
    assert rectified == 4 and int(tstate["count"]) == 9  # steps 6 to 9 rectify


@pytest.mark.parametrize("name", ["lion", "lamb", "adafactor"])
def test_unported_optimizers_are_named(name):
    with pytest.raises(NotImplementedError, match=name):
        toptim.make_clip_optimizer(tiny_config(optimizer=name), lambda s: 1e-3,
                                   {"log_temp": torch.zeros(())})


def test_freeze_fractions_and_masks_match_jax():
    """Same start fractions leaf for leaf as train/optim.freeze_fractions,
    and the same leaves zeroed by apply_freeze_mask at ratios 0, 0.3, 0.5,
    0.87, 1."""
    sizes = {
        "backbone/patch_embed/conv/kernel": (4, 6), "backbone/patch_embed/conv/bias": (6,),
        "backbone/cls": (1, 1, 6),
        "backbone/block0/attn/qkv/kernel": (6, 18), "backbone/block0/attn/qkv/bias": (18,),
        "backbone/block0/norm1/scale": (6,), "backbone/block0/norm1/bias": (6,),
        "backbone/block1/mlp/fc1/kernel": (6, 24), "backbone/block1/mlp/fc1/bias": (24,),
        "backbone/block10/mlp/fc1/kernel": (6, 24),
        "backbone/pool1/kernel": (6, 6),
        "backbone/norm/scale": (6,), "backbone/norm/bias": (6,),
        "proj/proj/kernel": (6, 4), "aggregator/query": (4,),
    }
    renames = {"kernel": "weight", "scale": "weight"}

    def tname(k):
        *mods, leaf = k.split("/")
        if leaf in renames and "conv" not in mods:
            leaf = renames[leaf]
        return ".".join(mods + [leaf])

    jtree = _nested({k: jnp.ones(s) for k, s in sizes.items()})
    ttree = {tname(k): torch.ones(s) for k, s in sizes.items()}
    jf = _flat(joptim.freeze_fractions(jtree, include=("backbone",)))
    tf = toptim.freeze_fractions(ttree, include=("backbone",))
    for k in sizes:
        assert tf[tname(k)] == pytest.approx(float(jf[k]), abs=1e-7), k
    jfr = joptim.freeze_fractions(jtree, include=("backbone",))
    for ratio in (0.0, 0.3, 0.5, 0.87, 1.0):
        jm = _flat(joptim.apply_freeze_mask(jtree, jfr, ratio))
        tm = toptim.apply_freeze_mask(ttree, tf, ratio)
        for k in sizes:
            assert float(tm[tname(k)].sum()) == float(jm[k].sum()), (ratio, k)
    # exclude: the text tower's rule
    jx = _flat(joptim.freeze_fractions(jtree, exclude=("proj",)))
    tx = toptim.freeze_fractions(ttree, exclude=("proj",))
    for k in sizes:
        assert tx[tname(k)] == pytest.approx(float(jx[k]), abs=1e-7), k


def test_global_norm_and_finite_gate():
    ts = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([[4.0]])}
    assert float(toptim.global_norm(ts)) == pytest.approx(
        float(joptim.global_norm({k: jnp.asarray(v.numpy()) for k, v in ts.items()})))
    assert float(toptim.finite_gate(torch.tensor(1.5))) == 1.0
    assert float(toptim.finite_gate(torch.tensor(float("nan")))) == 0.0
    assert float(toptim.finite_gate(torch.tensor(float("inf")))) == 0.0
    assert toptim.optimizer_step_count({"gradient_step": 4}, 9) == 4
    assert toptim.optimizer_step_count({"count": 1}, 9) == 9
