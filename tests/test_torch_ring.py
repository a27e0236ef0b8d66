"""The port's sequence parallelism against the JAX package: the mesh, ring
attention (both backends, forward and gradients), the ring video encoder
and the ring train step.

The JAX side runs on the suite's 8 CPU devices (``tests/conftest.py``), on
meshes of their first n; the port's side on meshes of n CPU shards,
``make_mesh(..., devices=["cpu"] * n)``. On the CPU ``backend="rdma"`` runs
K6's plain version (the slot protocol with the update in torch), as the
JAX side runs its Pallas kernel under the interpreter
(``"rdma_interpret"``). Inputs come from a numpy seed.

Tolerances. fp32: ``2e-5 + 2e-4|ref|``, the JAX ring tests' own (sums in
another order). bf16: ``4e-3 + 1e-2|ref|``: both rings round ``p`` to bf16
and the output to bf16 at the same points, from fp32 scores summed in
another order, so an element may differ by one bf16 step of the output
(2^-8 relative) or of a probability. The ring encoder and the train step:
the ``tests/test_torch_models.py`` and ``tests/test_torch_train.py``
tolerances.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.models import video_encoder as jve
from deepcoro_clip_tpu.ops.attention import multi_head_attention as jax_mha
from deepcoro_clip_tpu.parallel import MeshSpec as JMeshSpec
from deepcoro_clip_tpu.parallel import make_mesh as jmake_mesh
from deepcoro_clip_tpu.parallel.ring_attention import ring_attention as jring

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.models import layers as tl
from deepcoro_clip_tpu_torch.models import video_encoder as tve
from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
from deepcoro_clip_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshSpec,
    make_mesh,
    ring_attention,
)
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_rdma_plain, ring_xla
from deepcoro_clip_tpu_torch.train import clip as tclip

F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=4e-3, rtol=1e-2)
MODEL_TOL = dict(atol=1e-4, rtol=1e-5)


def _jmesh(n):
    return jmake_mesh(JMeshSpec(data=1, model=n), devices=jax.devices()[:n])


def _tmesh(n):
    return make_mesh(MeshSpec(data=1, model=n), devices=["cpu"] * n)


def _qkv(seed, shape):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(3)]


def _to_np(t):
    return t.detach().float().numpy()


@pytest.fixture
def ring_calls(monkeypatch):
    """Counts the model's calls of ``ring_attention``."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return ring_attention(*args, **kw)

    monkeypatch.setattr(tl, "ring_attention", counted)
    return calls


# --------------------------------------------------------------------------- #
# the mesh


def test_mesh_spec_resolve_and_make_mesh():
    assert MeshSpec(data=-1, model=2).resolve(8) == (4, 2)
    assert MeshSpec(data=2, model=0).resolve(4) == (2, 1)
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        MeshSpec(data=3, model=2).resolve(4)
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        make_mesh(MeshSpec(data=1, model=3), devices=["cpu"] * 2)
    mesh = make_mesh(MeshSpec(data=2, model=3), devices=["cpu"] * 7)  # one dropped
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 3}
    assert mesh.devices_along(MODEL_AXIS) == [torch.device("cpu")] * 3
    assert mesh.devices_along(DATA_AXIS) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.devices_along("seq")
    # the JAX spec resolves alike
    for spec in ((-1, 2, 8), (2, 0, 4), (1, 8, 8)):
        assert (MeshSpec(*spec[:2]).resolve(spec[2])
                == JMeshSpec(*spec[:2]).resolve(spec[2]))


def test_ring_attention_rejects_what_jax_rejects():
    q = torch.zeros(1, 2, 12, 8)
    with pytest.raises(ValueError, match="does not divide"):
        ring_attention(q, q, q, _tmesh(5))
    with pytest.raises(ValueError, match="unknown ring attention backend"):
        ring_attention(q, q, q, _tmesh(2), backend="nccl")


@pytest.mark.parametrize("dh,dtype,symbol", [
    (128, torch.bfloat16, "deepcoro_ring_step_sm90_bf16"),
    (64, torch.bfloat16, "deepcoro_ring_step_bf16"),
    (256, torch.bfloat16, "deepcoro_ring_step_wide_bf16"),
    (64, torch.float32, "deepcoro_ring_step_f32"),
    (128, torch.float32, "deepcoro_ring_step_f32"),
    (512, torch.float32, "deepcoro_ring_step_f32"),
])
def test_ring_step_kernel_choice(dh, dtype, symbol):
    """Which C entry of csrc/ring_attention.cu a ring step runs: in bf16 the
    Hopper kernel at Dh 128, the mma.sync one at 64, the SIMT one at 256 to
    512; the fp32 SIMT one at every width; a pure function of the head dim
    and the type, checked here without a card. Dh 96 is no kernel's: the
    ring pads it to 128 first (``kernel_head_dim``); fp16 and Dh above 512
    raise."""
    from deepcoro_clip_tpu_torch.ops import _ring_cuda

    assert _ring_cuda.step_symbol(dh, dtype) == symbol
    with pytest.raises(ValueError, match="Dh in"):
        _ring_cuda.step_symbol(96, dtype)
    with pytest.raises(ValueError, match="Dh in"):
        _ring_cuda.step_symbol(640, dtype)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        _ring_cuda.step_symbol(dh, torch.float16)
    assert _ring_cuda.kernel_head_dim(96) == 128 and _ring_cuda.kernel_head_dim(dh) == dh


# --------------------------------------------------------------------------- #
# ring attention against the JAX ring


@pytest.mark.parametrize("jax_backend", ["xla", "rdma_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_ring_attention_matches_jax(n, dtype, jax_backend):
    """Both port backends against the JAX ring at ``[2,2,64,16]``: the
    ``"xla"`` ring, and for the ``"rdma_interpret"`` cases the oracle that
    the JAX package's own ``tests/test_ring_attention.py`` holds its
    interpreted Pallas ring to (``multi_head_attention`` over the whole
    sequence). The interpreted ring is not deterministic under load: in six
    processes side by side (``tests/ring_determinism_probe.py``) it returned,
    in 21 of 144 calls at n = 8, outputs 0.34 to 0.60 off the oracle in 949 to
    2,900 of the 4,096 elements, while the ``"xla"`` ring and both of the
    port's rings gave the same bits every call (``ROADMAP.md``, Queue 3)."""
    q, k, v = _qkv(n, (2, 2, 64, 16))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    if jax_backend == "rdma_interpret":
        ref = np.asarray(jax_mha(*args), np.float32)
    else:
        ref = np.asarray(jring(*args, _jmesh(n), axis="model", backend=jax_backend),
                         np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    before = ring_attention.launches
    for backend in ("xla", "rdma"):
        got = ring_attention(tq, tk, tv, _tmesh(n), axis="model", backend=backend)
        assert got.dtype == tdt and got.shape == tq.shape
        np.testing.assert_allclose(_to_np(got), ref, **tol, err_msg=backend)
    assert ring_attention.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plain_k6_protocol_equals_the_xla_ring(n):
    """The slot protocol folds the same chunks in the same order as the
    rotations of the ``"xla"`` ring: the two agree bit for bit."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(10 + n, (2, 3, 8 * n, 16)))
    chunks = [list(t.chunk(n, dim=2)) for t in (q, k, v)]
    for a, b in zip(ring_rdma_plain(*chunks, 0.3), ring_xla(*chunks, 0.3)):
        assert torch.equal(a, b)
    full = multi_head_attention(q, k, v, scale=0.3)
    got = ring_attention(q, k, v, _tmesh(n), scale=0.3, backend="rdma_interpret")
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_rdma_ring_gradients_match_jax(n):
    """Gradients of ``sum(out**2)`` through the port's ``"rdma"`` (K6's
    plain forward, the ``"xla"`` ring's backward) against ``jax.grad``
    through ``"rdma_interpret"``, fp32."""
    q, k, v = _qkv(20 + n, (2, 2, 64, 16))

    def jloss(q, k, v):
        return jnp.sum(jring(q, k, v, _jmesh(n), axis="model",
                             backend="rdma_interpret") ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ring_attention(*leaves, _tmesh(n), backend="rdma")
    assert out.grad_fn is not None
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL, err_msg=name)


# --------------------------------------------------------------------------- #
# the ring in the model


def _videos(cfg, B=2, seed=0):
    r = np.random.default_rng(seed)
    return r.normal(size=(B, cfg.num_videos, cfg.frames, cfg.resize, cfg.resize,
                          3)).astype(np.float32)


@pytest.mark.parametrize("use_cls_token", [False, True])
def test_ring_video_encoder_matches_jax(ring_calls, use_cls_token):
    """Converted JAX weights, both encoders with a ring mesh of 2. Without a
    CLS token the 8 tokens divide by 2 and every block takes the ring; with
    one, 9 tokens do not, and every block takes the standard path (the
    guard) in both packages."""
    kw = dict(use_cls_token=use_cls_token, dropout=0.0, precision="fp32",
              use_pallas_attention=False)
    jcfg, tcfg = jax_tiny(**kw), tiny_config(**kw)
    jm = jve.video_encoder_from_config(jcfg, ring_mesh=jmake_mesh(JMeshSpec(4, 2)))
    x = _videos(jcfg)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    ref = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    tm = tve.video_encoder_from_config(tcfg, ring_mesh=_tmesh(2))
    tree = jax.tree_util.tree_map(np.asarray, fnn.unbox(params))
    tm.load_state_dict(convert.jax_tree_to_state_dict(tree), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **MODEL_TOL)
    assert len(ring_calls) == (0 if use_cls_token else jcfg.vit_depth)


def _ring_batch(cfg, B):
    r = np.random.default_rng(0)
    return {
        "videos": _videos(cfg, B),
        "video_mask": np.ones((B, cfg.num_videos), bool),
        "input_ids": r.integers(0, cfg.text_vocab_size,
                                (B, cfg.max_text_length)).astype(np.int32),
        "attention_mask": np.ones((B, cfg.max_text_length), np.int32),
    }


def _loss_and_grads(bundle, state, batch):
    params = state.params
    out = tclip.compute_loss(bundle, params["log_temp"], batch, deterministic=True)
    names = [n for n, p in params.items() if p.requires_grad and n != "logit_bias"]
    grads = torch.autograd.grad(out["loss"], [params[n] for n in names])
    return float(out["loss"].detach()), dict(zip(names, grads))


def test_ring_train_step_from_config(ring_calls):
    """``build_clip_bundle`` with ``use_ring_attention`` over a mesh of 2 CPU
    shards: 4 steps with finite, falling losses (the JAX
    ``test_ring_train_step_from_config``); the first loss and its gradients
    equal those of the same bundle built without the ring."""
    cfg = tiny_config(batch_size=4, use_cls_token=False, dropout=0.0,
                      use_ring_attention=True)
    bundle, state = tclip.build_clip_bundle(cfg, seed=0, steps_per_epoch=4,
                                            device="cpu", mesh=_tmesh(2))
    batch = tclip.to_device_batch(bundle, _ring_batch(cfg, 4))
    loss_r, grads_r = _loss_and_grads(bundle, state, batch)
    assert len(ring_calls) == cfg.vit_depth
    dense, dstate = tclip.build_clip_bundle(
        dataclasses.replace(cfg, use_ring_attention=False), seed=0,
        steps_per_epoch=4, device="cpu")
    loss_d, grads_d = _loss_and_grads(dense, dstate, batch)
    assert len(ring_calls) == cfg.vit_depth
    np.testing.assert_allclose(loss_r, loss_d, rtol=1e-5)
    assert grads_r.keys() == grads_d.keys()
    for name in grads_r:
        np.testing.assert_allclose(grads_r[name].numpy(), grads_d[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)

    step = tclip.make_train_step(bundle)
    losses = []
    for _ in range(4):
        state, m = step(state, batch, None, 0.0, 0.0, -1.0)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert len(ring_calls) == 5 * cfg.vit_depth


def test_ring_bundle_builds_its_mesh_from_the_config():
    """Without a mesh the bundle builds one from ``mesh_data``/``mesh_model``;
    on the CPU that is the bundle's one device, so a ring of 2 raises as the
    JAX mesh does on too few devices."""
    cfg = tiny_config(use_cls_token=False, use_ring_attention=True, mesh_model=2)
    with pytest.raises(ValueError, match="needs at least 2 devices, have 1"):
        tclip.build_clip_bundle(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tclip.build_clip_bundle(dataclasses.replace(cfg, mesh_data=1), device="cpu")
    bundle, _ = tclip.build_clip_bundle(dataclasses.replace(cfg, mesh_model=1),
                                        device="cpu")
    attn = bundle.video_model.backbone.block0.attn
    assert attn.ring_mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    assert bundle.video_model.aggregator.block0.attn.ring_mesh is None
