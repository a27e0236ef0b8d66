"""Tensor parallelism of the port over the ``model`` axis, layer by layer: two
``gloo`` ranks on the CPU cut every attention's heads and every MLP's
hidden width in two (``models/layers.shard_layers``), against the JAX
layers on ``make_mesh(MeshSpec(data=1, model=2))`` of the conftest's CPU
devices, their parameters placed by ``nn.get_partition_spec``
(``train/state.replicate_state``), at fp32.

The ranks are ``torch.multiprocessing`` children
(``tests/test_torch_tp_workers.py``, which imports the port only, through
``tests/test_torch_ddp_workers.start``); one module-scoped launch runs while
the JAX side computes.

- Each layer (``MlpBlock``; ``Attention`` self at Dh 64 with a key mask,
  packed at Dh 128 with RoPE, the fused output projection (K5's path, its
  plain version on the CPU), cross with a context of another width;
  ``TransformerBlock``; ``BertLayer`` with the tokenizer's mask), loaded
  from the JAX layer's whole tree: the output, the input's (and context's)
  gradient and every parameter gradient, the cut ones gathered whole, of
  ``sum(out * dout)`` against ``jax.vjp`` of the JAX layer: outputs and
  input gradients within 1e-4 + 1e-5|ref| (the one-process model tests'
  bar: fp32 sums in another order), each parameter gradient within 1e-4 of
  its largest magnitude (1e-6 absolute), the key bias's, zero up to
  rounding, within 1e-4 of the layer's largest gradient. Both ranks hold
  the same output bits.
- The cuts: each rank holds half of every column- and row-parallel weight
  and of every column-parallel bias (the row-parallel biases whole), under
  ``train/state.partition_rule``'s cut; the fused ``qkv`` by head.
- The MLP's hidden dropout draws the whole width's mask and keeps the
  rank's columns: the output with dropout equals the uncut layer's under
  the same generator (1e-6).
- A layer whose heads ``M`` does not divide (3 heads over 2) stays whole,
  rank 0 logs it naming the layer, and it computes what the uncut layer
  does.
- The captioning decoder's greedy generation with the K/V cache (the
  cache at the rank's heads) gives the uncut decoder's ids, and so does the
  full recompute.
- The element counts of every cut parameter, its gradient and its two
  Adam moments on a rank of a CLIP bundle: half of the whole.
- ``convert.shard_tree`` then ``gather_state_dicts`` is the identity, bit
  for bit, on the CLIP, LocCa, probing and multitask trees, and each rank's
  state dict loads strictly into the cut models.
- ``mesh_model`` 2 without the ring raises at world 1, naming the launch.
"""

import dataclasses
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.models import layers as jl
from deepcoro_clip_tpu.models import text_encoder as jtext
from deepcoro_clip_tpu.ops.rope3d import build_rope3d_tables
from deepcoro_clip_tpu.parallel import MeshSpec as JMeshSpec
from deepcoro_clip_tpu.parallel import make_mesh as jmake_mesh
from deepcoro_clip_tpu.train import state as jstate

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.models.layers import shard_layers
from deepcoro_clip_tpu_torch.parallel.mesh import ProcessMesh
from deepcoro_clip_tpu_torch.train import clip as tclip
from deepcoro_clip_tpu_torch.train import linear_probe as tprobe
from deepcoro_clip_tpu_torch.train import multitask as tmt
from deepcoro_clip_tpu_torch.train.state import QKV, partition_rule

from tests import test_torch_ddp_workers as workers
from tests import test_torch_tp_workers as tp_workers

M = 2
TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_REL, GRAD_ATOL = 1e-4, 1e-6


def _mesh():
    return jmake_mesh(JMeshSpec(data=1, model=M), devices=jax.devices()[:M])


def _layer_cases():
    """(name, JAX module, port case without params, JAX call arguments)."""
    r = np.random.default_rng(17)
    t64 = build_rope3d_tables(128, 2, 3, 3, n_special=1)
    L = t64.sin.shape[0]
    cases = []

    def x(*shape):
        return r.normal(size=shape).astype(np.float32)

    mask = r.random((2, 11)) > 0.3
    mask[:, 0] = True
    cases.append(("mlp", jl.MlpBlock(96, 32, dtype=jnp.float32),
                  dict(kind="mlp", dim=32, heads=1, hidden=96, x=x(2, 5, 32)), {}))
    cases.append(("mlp_dropout", jl.MlpBlock(96, 32, dtype=jnp.float32),
                  dict(kind="mlp", dim=32, heads=1, hidden=96, x=x(2, 5, 32), dropout=0.5),
                  {}))
    cases.append(("attention_dh64_mask", jl.Attention(256, 4, dtype=jnp.float32),
                  dict(kind="attention", dim=256, heads=4, cross=False, x=x(2, 11, 256),
                       mask=mask), {"kv_mask": mask}))
    rope = dict(sin=t64.sin, cos=t64.cos)
    cases.append(("attention_packed_dh128_rope", jl.Attention(512, 4, dtype=jnp.float32),
                  dict(kind="attention", dim=512, heads=4, cross=False, x=x(2, L, 512), **rope),
                  rope))
    cases.append(("attention_fused_projection", jl.Attention(512, 4, dtype=jnp.float32),
                  dict(kind="attention", dim=512, heads=4, cross=False, fused=True,
                       x=x(2, L, 512), **rope), rope))
    ctx = x(2, 9, 48)
    cases.append(("attention_cross", jl.Attention(64, 4, dtype=jnp.float32),
                  dict(kind="attention", dim=64, heads=4, cross=True, context_dim=48,
                       x=x(2, 6, 64), context=ctx), {"context": ctx}))
    cases.append(("transformer_block", jl.TransformerBlock(64, 4, dtype=jnp.float32),
                  dict(kind="block", dim=64, heads=4, x=x(2, 11, 64), mask=mask),
                  {"kv_mask": mask}))
    att = np.ones((2, 11), np.int32)
    att[1, 6:] = 0
    cases.append(("bert_layer", jtext.BertLayer(64, 4, 128, dropout=0.0, dtype=jnp.float32),
                  dict(kind="bert", dim=64, heads=4, hidden=128, x=x(2, 11, 64), mask=att),
                  {"attention_mask": att}))
    return cases


LAYERS = [c[0] for c in _layer_cases()]
# the JAX layers run deterministic: the dropout case is held to the uncut layer
JAX_LAYERS = [n for n in LAYERS if n != "mlp_dropout"]
# where each case's module sits in a model, for its parameters' full names
PREFIX = {"mlp": "mlp.", "attention": "attn.", "block": "", "bert": "layer0."}


def _jax_layer(module, case, call_kw):
    """Init the JAX layer, place its parameters on the (1, 2) mesh by their
    partition specs, and take the output and ``jax.vjp`` of
    ``sum(out * dout)`` under jit."""
    x = jnp.asarray(case["x"])
    args = {k: jnp.asarray(v) for k, v in call_kw.items()}
    if "attention_mask" in args:  # BertLayer's positional argument
        variables = module.init(jax.random.PRNGKey(3), x, args["attention_mask"])
    else:
        variables = module.init(jax.random.PRNGKey(3), x, **args)
    params, spec = jstate.unbox_with_spec(variables)
    placed = jstate.replicate_state(params, _mesh(), spec)
    ctx = args.pop("context", None)

    def f(p, x, c):
        if "attention_mask" in args:
            return module.apply(p, x, args["attention_mask"])
        if c is not None:
            return module.apply(p, x, context=c, **args)
        return module.apply(p, x, **args)

    out, vjp = jax.vjp(jax.jit(f), placed, x, ctx)
    dout = np.random.default_rng(29).normal(size=out.shape).astype(np.float32)
    gp, gx, gc = vjp(jnp.asarray(dout))
    whole = jax.tree_util.tree_map(np.asarray, fnn.unbox(params["params"]))
    grads = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, gp["params"]))
    return whole, dout, {"out": np.asarray(out), "dx": np.asarray(gx),
                         "dcontext": None if gc is None else np.asarray(gc), "grads": grads}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX layers' results, the two ranks' results)."""
    root = tmp_path_factory.mktemp("tp_layers")
    cases, refs = {}, {}
    for name, module, case, call_kw in _layer_cases():
        params, dout, refs[name] = _jax_layer(module, case, call_kw)
        cases[name] = dict(case, params=params, dout=dout)
    r = np.random.default_rng(31)
    spec = {"model": M, "layers": cases,
            "greedy": {"tokens": r.normal(size=(3, 5, 24)).astype(np.float32)}}
    (root / "layers.pkl").write_bytes(pickle.dumps(spec))
    cfg = dict(_counts_config(), mesh_model=M)
    counts = {"config": cfg, "batch": _clip_batch(cfg)}
    (root / "counts.pkl").write_bytes(pickle.dumps(counts))
    (root / "job.pkl").write_bytes(pickle.dumps({"layers": str(root / "layers.pkl"),
                                                 "counts": str(root / "counts.pkl")}))
    ranks = workers.spawn(tp_workers.job, M, root, str(root / "job.pkl"))
    return refs, ranks


def _clip_batch(cfg):
    r = np.random.default_rng(0)
    B, L = 4, cfg["max_text_length"]
    att = np.ones((B, L), np.int32)
    att[1, 9:] = 0
    return {"videos": r.normal(size=(B, cfg["num_videos"], cfg["frames"], cfg["resize"],
                                     cfg["resize"], 3)).astype(np.float32),
            "video_mask": np.ones((B, cfg["num_videos"]), bool),
            "input_ids": r.integers(0, 256, (B, L)).astype(np.int32),
            "attention_mask": att}


# --------------------------------------------------------------------------- #
# the layers against the JAX layers on the (1, 2) mesh


def _key_bias_apart(k, a, b, top):
    """The key bias's gradient is zero up to rounding (the softmax does not
    see it): held to GRAD_REL of the tree's largest gradient, and left out
    of the leaf's own bar (the middle third of a fused qkv bias)."""
    if k.split("/")[-2:] in (["k", "bias"], ["key", "bias"]):
        np.testing.assert_allclose(a, b, atol=GRAD_REL * top, rtol=0, err_msg=k)
        return a[:0], b[:0]
    if k.endswith("qkv/bias"):
        n = a.shape[0] // 3
        np.testing.assert_allclose(a[n:2 * n], b[n:2 * n], atol=GRAD_REL * top, rtol=0,
                                   err_msg=k)
        return np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
    return a, b


@pytest.mark.parametrize("name", JAX_LAYERS)
def test_layer_matches_jax_on_the_model_axis(runs, name):
    refs, ranks = runs
    want = refs[name]
    for got in (r["layers"][name] for r in ranks):
        np.testing.assert_allclose(got["out"], want["out"], **TOL)
        np.testing.assert_allclose(got["dx"], want["dx"], **TOL)
        if want["dcontext"] is not None:
            np.testing.assert_allclose(got["dcontext"], want["dcontext"], **TOL)
        assert got["grads"].keys() == want["grads"].keys()
        top = max(float(np.abs(g).max()) for g in want["grads"].values())
        for k, g in want["grads"].items():
            a, b = _key_bias_apart(k, got["grads"][k], g, top)
            atol = max(GRAD_REL * float(np.abs(b).max(initial=0.0)), GRAD_ATOL)
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ranks[0]["layers"][name]["out"],
                                  ranks[1]["layers"][name]["out"])


@pytest.mark.parametrize("name", LAYERS)
def test_each_rank_holds_half_of_every_cut_weight(runs, name):
    """Half of each weight the JAX spec shards (and of each column-parallel
    bias), the rest whole, by ``partition_rule`` of the parameter's name in
    a model; the fused qkv cut by head."""
    _, ranks = runs
    kind = dict((c[0], c[2]["kind"]) for c in _layer_cases())[name]
    for got in (r["layers"][name] for r in ranks):
        assert not got["kept"]
        cut = got["splits"]
        assert any(k.endswith("weight") for k in cut), cut
        for k, (here, whole) in got["numel"].items():
            assert here * (M if k in cut else 1) == whole, k
            rule = partition_rule(PREFIX[kind] + k)
            assert (tuple(rule) if rule else None) == cut.get(k), k
        for k in ("qkv.weight", "attn.qkv.weight"):
            if k in cut:
                assert cut[k] == tuple(QKV)


def test_mlp_dropout_keeps_the_whole_widths_mask(runs):
    _, ranks = runs
    for got in (r["layers"]["mlp_dropout"] for r in ranks):
        np.testing.assert_allclose(got["out"], got["uncut_out"], atol=1e-6, rtol=0)
        assert 0.3 < float((got["out"] == 0).mean()) < 0.7  # rate 0.5 on the output
    np.testing.assert_array_equal(ranks[0]["layers"]["mlp_dropout"]["out"],
                                  ranks[1]["layers"]["mlp_dropout"]["out"])


def test_a_layer_the_model_axis_does_not_divide_stays_whole(runs):
    _, ranks = runs
    for i, r in enumerate(ranks):
        odd = r["layers"]["odd_heads"]
        assert odd["kept"] == {"attn": "3 heads"}
        assert odd["shapes"]["attn.qkv.weight"] == odd["uncut_shapes"]["attn.qkv.weight"]
        assert odd["shapes"]["mlp.fc1.weight"] == (96, 48)  # the MLP is cut
        np.testing.assert_allclose(odd["out"], odd["uncut_out"], atol=1e-5, rtol=1e-5)
        if i == 0:
            assert "TransformerBlock.attn stays whole on every rank (3 heads" in odd["log"]
        else:
            assert odd["log"] == ""


def test_greedy_generation_with_the_kv_cache_at_model_2(runs):
    _, ranks = runs
    for r in ranks:
        g = r["layers"]["greedy"]
        assert g["cache_heads"] == 1
        np.testing.assert_array_equal(g["kv"], g["uncut_kv"])
        np.testing.assert_array_equal(g["full"], g["uncut_kv"])


def test_cut_parameters_gradients_and_moments_hold_half(runs):
    _, ranks = runs
    one, _ = tclip.build_clip_bundle(tconfigs.ClipConfig.from_dict(_counts_config()),
                                     seed=0, device="cpu")
    whole = dict(one.video_model.named_parameters(prefix="video_encoder"))
    whole.update(one.text_model.named_parameters(prefix="text_encoder"))
    for r in ranks:
        c = r["counts"]
        assert c["M"] == M and len(c["counts"]) > 20
        for k, (param, grad, mu, nu) in c["counts"].items():
            assert param * M == whole[k].numel() and param == grad == mu == nu, k
            assert c["grad_split"][k], k
        assert any(".attn.qkv." in k for k in c["counts"])
        assert any("layer0.intermediate." in k for k in c["counts"])


def _counts_config():
    return dict(dataclasses.asdict(tiny_config()), text_heads=2, vit_heads=2, batch_size=4)


# --------------------------------------------------------------------------- #
# the trees, shard and gather


def _fake_grid(i):
    """Rank i of a (1, 2) grid, without a process group (cuts only)."""
    return ProcessMesh(1, M, i, {})


def _clip_tree(**over):
    cfg = tiny_config(text_heads=2, vit_heads=2, **over)
    b, s = tclip.build_clip_bundle(cfg, seed=0, device="cpu")
    p = s.params
    tree = convert.training_tree(b.video_model, b.text_model, p["log_temp"],
                                 p["logit_bias"], b.locca_decoder)
    return tree, lambda: tclip.build_clip_bundle(cfg, seed=0, device="cpu")[0]


def _probe_tree():
    cfg = tconfigs.LinearProbingConfig.from_dict(dict(
        frames=4, resize=32, batch_size=3, num_videos=3, vit_dim=32, vit_depth=1,
        vit_heads=2, vit_patch=[2, 16, 16], embedding_dim=32, num_heads=2,
        attention_hidden=8, precision="fp32", pooling_mode="attention+cls_token",
        use_cls_token=True, normalization_strategy="pre_norm",
        head_structure={"stenosis": 1, "CTO": 1},
        loss_structure={"stenosis": "huber", "CTO": "bce_logit"}))
    b, _ = tprobe.build_probe_bundle(cfg, seed=0, device="cpu")
    return convert.probe_tree(b.video_model, b.mil_model), None


def _multitask_tree():
    cfg = tconfigs.MultitaskConfig.from_dict(dict(
        _counts_config(), decoder_dim=16, decoder_depth=1, decoder_heads=2,
        decoder_max_length=8, mvm_decoder_dim=8, mvm_decoder_depth=1))
    b, s = tmt.build_multitask_bundle(cfg, seed=0, device="cpu")
    return convert.multitask_tree({"video_encoder": b.video_model,
                                   "text_encoder": b.text_model, "decoder": b.decoder,
                                   "mvm": b.mvm}, s.params["log_temp"]), None


TREE_OF = {"clip": _clip_tree,
           "locca": lambda: _clip_tree(locca_enabled=True, locca_num_heads=2,
                                       locca_d_model=16, locca_num_layers=1,
                                       locca_max_seq_len=8),
           "probe": _probe_tree, "multitask": _multitask_tree}


@pytest.mark.parametrize("which", TREE_OF)
def test_shard_and_gather_round_trip(which):
    tree, rebuild = TREE_OF[which]()
    whole = convert.jax_tree_to_state_dict(tree)
    parts = [convert.shard_tree(tree, M, i) for i in range(M)]
    cut = [k for k in whole if partition_rule(k) is not None]
    assert cut and all(parts[0][k].numel() * M == whole[k].numel() for k in cut)
    back = convert.gather_state_dicts(parts)
    assert back.keys() == whole.keys()
    for k, v in whole.items():
        assert torch.equal(back[k], v), k
    if rebuild is None:
        return
    for i, part in enumerate(parts):  # rank i's state dict fits the cut models
        b = rebuild()
        for m, top in zip((b.video_model, b.text_model), ("video_encoder", "text_encoder")):
            shard_layers(m, _fake_grid(i))
            m.load_state_dict({k[len(top) + 1:]: v for k, v in part.items()
                               if k.startswith(top + ".")}, strict=True)


def test_tensor_parallelism_needs_the_ranks_at_world_1():
    cfg = tiny_config(mesh_model=2)
    with pytest.raises(ValueError, match=r"torch\.distributed\.run --nproc_per_node 2"):
        cfg.set_device_info_in_place()
