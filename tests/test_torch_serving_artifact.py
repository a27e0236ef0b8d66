"""The port's frozen serving artifacts (``serving.py``) against the JAX package's.

The same trees go through both: the JAX package's ``export_retrieval_artifact``
/ ``export_probing_artifact`` export a random init on the CPU (the tree read
back from its ``params.msgpack``), ``convert.py`` carries it into the port's
modules, and the port exports its own artifact from them, on the CPU. Tiny
widths, but a backbone of 2 heads of 128, so that the port's blocks take the
packed path (K1's operator) and, with the fused projection, K5's; the
aggregator and the MIL head's CLS block take the ``[B, H, L, Dh]`` path
(K3's). The port runs ``use_pallas_attention`` on, the JAX side off (its
XLA attention; the parameters do not depend on the switch).

Held: embeddings, scores and logits against the JAX artifact and the JAX
programs ``_retrieval_fn`` / ``_probing_fn`` (atol 1e-4, fp32, sums in
another order), top-k indices equal; bit-equal to the port's in-process
engine and ``forward_heads``; layout and meta; padding of a short batch;
``swap_params``; the format, kind and platform guards; the exported graph
(the port's operators, no attention taken apart); the operators' CPU
kernels against the plain versions (bit-equal) and their fake kernels;
``export_model``'s four subcommands through its ``main``; ``serve
--artifact`` over HTTP; the CUDA default of the new entry points.
"""

import http.client
import json
import shutil
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from deepcoro_clip_tpu import serving as jserving
from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny
from deepcoro_clip_tpu.models.video_encoder import (
    video_encoder_from_config as jax_video_encoder,
)
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.train.linear_probe import _mil_from_config as jax_mil

from deepcoro_clip_tpu_torch import convert, export_model, serve, serving
from deepcoro_clip_tpu_torch.configs import parse_config
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.models.video_encoder import video_encoder_from_config
from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention, project_plain
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.ops.flash_attention_packed import flash_attention_packed
from deepcoro_clip_tpu_torch.train import linear_probe as probe_train

jax_register_all()

ATOL = 1e-4
NUM_VIDEOS, MAX_BATCH, TOP_K, BANK = 3, 2, 4, 24
# a backbone of 2 heads of 128: the packed path (K1, K5); the aggregator's
# and the head's heads of 16 and 8: the [B, H, L, Dh] path (K3)
WIDE = dict(vit_dim=256, vit_heads=2, vit_depth=1, dataset_mean=[110.5, 98.2, 101.0],
            dataset_std=[37.8, 41.2, 39.9])


def _studies(meta, b, seed=1):
    r = np.random.default_rng(seed)
    st = r.integers(0, 256, (b, meta["num_videos"], meta["tokens_per_clip"],
                             meta["patch_bytes"]), dtype=np.uint8)
    mask = np.ones((b, meta["num_videos"]), bool)
    mask[-1, 1:] = False  # a study of one clip
    return st, mask


def _tree(path):
    return jax.tree_util.tree_map(np.asarray, serialization.msgpack_restore(
        (path / jserving.PARAMS_FILE).read_bytes()))


# --------------------------------------------------------------------------- #
# retrieval


@pytest.fixture(scope="module")
def retrieval(tmp_path_factory):
    jcfg = jax_tiny(multi_video=True, num_videos=NUM_VIDEOS, **WIDE)
    r = np.random.default_rng(0)
    bank = r.normal(size=(BANK, jcfg.embedding_dim))
    texts = [f"report {i}" for i in range(BANK)]
    jdir = tmp_path_factory.mktemp("jax_retrieval")
    jserving.export_retrieval_artifact(jcfg, jdir, bank, texts, max_batch=MAX_BATCH,
                                       top_k=TOP_K)
    jart = jserving.RetrievalArtifact(jdir)
    cfg = tiny_config(multi_video=True, num_videos=NUM_VIDEOS, use_pallas_attention=True,
                      **WIDE)
    sd = convert.jax_tree_to_state_dict(_tree(jdir))
    tdir = tmp_path_factory.mktemp("port_retrieval")
    meta = serving.export_retrieval_artifact(cfg, tdir, bank, texts, max_batch=MAX_BATCH,
                                             top_k=TOP_K, video_params=sd, device="cpu")
    return dict(jcfg=jcfg, jdir=jdir, jart=jart, cfg=cfg, sd=sd, tdir=tdir, meta=meta,
                art=serving.RetrievalArtifact(tdir, device="cpu"), bank=bank, texts=texts)


@pytest.mark.parametrize("reference", ["jax_artifact", "jax_retrieval_fn"])
@pytest.mark.parametrize("b", [MAX_BATCH, 1])
def test_retrieval_matches_jax(retrieval, reference, b):
    st, mask = _studies(retrieval["meta"], b)
    got = retrieval["art"].infer_batch(st, mask)
    if reference == "jax_artifact":
        want = retrieval["jart"].infer_batch(st, mask)
    else:
        jart = retrieval["jart"]
        fn = jax.jit(jserving._retrieval_fn(jax_video_encoder(retrieval["jcfg"]), TOP_K))
        pst, pmask, _ = jart._pad(st, mask)
        want = [np.asarray(a)[:b] for a in fn(jart._params, jart._bank, jnp.asarray(pst),
                                               jnp.asarray(pmask))]
    assert got[0].shape == (b, 32) and got[2].shape == (b, TOP_K)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("b", [MAX_BATCH, 1])
def test_retrieval_bit_equal_to_the_engine(retrieval, b):
    engine = serve.InferenceEngine(retrieval["cfg"], retrieval["bank"], retrieval["texts"],
                                   max_batch=MAX_BATCH, top_k=TOP_K,
                                   video_params=retrieval["sd"], device="cpu")
    st, mask = _studies(retrieval["meta"], b, seed=4)
    for a, e in zip(retrieval["art"].infer_batch(st, mask), engine.infer_batch(st, mask)):
        np.testing.assert_array_equal(a, e)


def test_retrieval_layout_and_meta(retrieval):
    meta, tdir = retrieval["meta"], retrieval["tdir"]
    for f in (serving.PROGRAM_FILE, serving.PARAMS_FILE, serving.BANK_FILE,
              serving.META_FILE):
        assert (tdir / f).stat().st_size > 0
    assert json.loads((tdir / serving.META_FILE).read_text()) == meta
    jmeta = json.loads((retrieval["jdir"] / jserving.META_FILE).read_text())
    assert set(meta) == (set(jmeta) - {"jax_version"}) | {"torch_version", "cuda_arch",
                                                           "ops", "kernels"}
    for k in set(jmeta) - {"jax_version", "platforms"}:
        assert meta[k] == jmeta[k], k
    assert meta["platforms"] == ["cpu"] and meta["cuda_arch"] is None
    assert meta["torch_version"] == torch.__version__
    # 1 backbone block on the packed layout, 1 aggregator block on [B, H, L, Dh]
    assert meta["kernels"] == {"K1": 1, "K3": 1}
    assert meta["ops"] == {"deepcoro::attention": 2}
    params = torch.load(tdir / serving.PARAMS_FILE, weights_only=True)
    assert params.keys() == retrieval["sd"].keys()
    # the parameters live in params.pt alone: the program holds the graph,
    # the RoPE tables and no example inputs
    assert (tdir / serving.PROGRAM_FILE).stat().st_size < \
        (tdir / serving.PARAMS_FILE).stat().st_size / 4
    with np.load(tdir / serving.BANK_FILE) as z:
        np.testing.assert_allclose(np.linalg.norm(z["text_embeddings"], axis=1), 1.0,
                                   rtol=1e-6)
        assert z["texts"].tolist() == retrieval["texts"]


def test_short_batch_pads_to_the_exported_shape(retrieval):
    """A short batch is padded with fully masked studies: the real rows
    come out as in the full batch, bit for bit."""
    art = retrieval["art"]
    st, mask = _studies(retrieval["meta"], MAX_BATCH)
    full = art.infer_batch(st, mask)
    solo = art.infer_batch(st[:1], mask[:1])
    for a, b in zip(solo, full):
        assert a.shape[0] == 1
        np.testing.assert_array_equal(a, b[:1])
    big, bm = _studies(retrieval["meta"], MAX_BATCH + 1)
    with pytest.raises(ValueError, match="max_batch"):
        art.infer_batch(big, bm)


def test_swap_params(retrieval):
    """Another tower of the same shape drops in without re-export and
    answers as an engine built on it; the original comes back as it was."""
    from deepcoro_clip_tpu_torch.models.video_encoder import init_params

    art = serving.RetrievalArtifact(retrieval["tdir"], device="cpu")
    st, mask = _studies(retrieval["meta"], MAX_BATCH, seed=2)
    before = art.infer_batch(st, mask)
    other = dict(init_params(video_encoder_from_config(retrieval["cfg"]), seed=7)
                 .state_dict())
    art.swap_params(dict(sorted(other.items(), reverse=True)))  # any key order
    engine = serve.InferenceEngine(retrieval["cfg"], retrieval["bank"], retrieval["texts"],
                                   max_batch=MAX_BATCH, top_k=TOP_K, video_params=other,
                                   device="cpu")
    swapped = art.infer_batch(st, mask)
    for a, e in zip(swapped, engine.infer_batch(st, mask)):
        np.testing.assert_array_equal(a, e)
    assert np.abs(swapped[0] - before[0]).max() > 1e-3
    art.swap_params(retrieval["sd"])
    for a, b in zip(art.infer_batch(st, mask), before):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        art.swap_params({k: v for k, v in other.items() if "aggregator" not in k})
    wrong = dict(other, **{"proj.proj.bias": torch.zeros(5)})
    with pytest.raises(ValueError, match="shaped"):
        art.swap_params(wrong)


@pytest.mark.parametrize("guard", ["format", "kind", "platform"])
def test_guards(retrieval, probing, tmp_path, guard):
    src = retrieval["tdir"]
    alien = tmp_path / "alien"
    shutil.copytree(src, alien)
    meta = json.loads((alien / serving.META_FILE).read_text())
    if guard == "format":
        meta["format"] = serving.FORMAT_VERSION + 1
    elif guard == "platform":
        meta["platforms"] = ["cuda"]  # a CUDA artifact refuses the CPU
    (alien / serving.META_FILE).write_text(json.dumps(meta))
    match = {"format": "format", "kind": "kind", "platform": "exported for"}[guard]
    with pytest.raises(ValueError, match=match):
        if guard == "kind":
            serving.ProbingArtifact(alien, device="cpu")
        else:
            serving.RetrievalArtifact(alien, device="cpu")
    if guard == "kind":
        with pytest.raises(ValueError, match="kind"):
            serving.RetrievalArtifact(probing["plain"]["tdir"], device="cpu")


def test_the_graph_calls_the_operators(retrieval, tmp_path):
    """The loaded program holds the port's operator once a block, and no
    attention taken apart: its one softmax is the aggregator's pooling over
    the videos. The same tower without the kernels (``use_pallas_attention``
    off) shows what a decomposition looks like: a softmax a block more."""
    ep = torch.export.load(retrieval["tdir"] / serving.PROGRAM_FILE)
    ops = serving.program_ops(ep)
    assert ops["deepcoro::attention"] == 2 and ops["aten::softmax.int"] == 1
    assert serving.decomposed_attention(ep) == []
    plain_cfg = tiny_config(multi_video=True, num_videos=NUM_VIDEOS, **WIDE)
    serving.export_retrieval_artifact(plain_cfg, tmp_path, retrieval["bank"],
                                      retrieval["texts"], max_batch=MAX_BATCH, top_k=TOP_K,
                                      video_params=retrieval["sd"], device="cpu")
    plain = serving.program_ops(torch.export.load(tmp_path / serving.PROGRAM_FILE))
    assert "deepcoro::attention" not in plain and plain["aten::softmax.int"] == 3


# --------------------------------------------------------------------------- #
# probing


PROBE = dict(
    pipeline_project="DeepCORO_video_linear_probing", run_mode="train",
    data_filename="unused.csv", output_dir="unused", frames=4, resize=32,
    multi_video=True, num_videos=NUM_VIDEOS,
    head_structure={"stenosis": 1, "cto": 1, "vessel": 3},
    loss_structure={"stenosis": "huber", "cto": "bce_logit", "vessel": "ce"},
    head_task={"stenosis": "regression", "cto": "binary", "vessel": "multiclass"},
    pooling_mode="attention+cls_token", vit_patch=[2, 16, 16], embedding_dim=16,
    num_heads=2, attention_hidden=8, dropout=0.0, precision="fp32",
    use_pallas_attention=False, use_wandb=False, **WIDE)
VARIANTS = {
    "plain": {},
    "view_ids": dict(use_view_embeddings=True, view_column="view_id", num_view_classes=3),
    "hierarchical": dict(hierarchical_tokens=True),
}


def _view_ids(meta, b):
    return (np.arange(b * meta["num_videos"], dtype=np.int32)
            .reshape(b, meta["num_videos"]) % 4)  # 3 = PAD


@pytest.fixture(scope="module")
def probing(tmp_path_factory):
    out = {}
    for name, over in VARIANTS.items():
        root = tmp_path_factory.mktemp(f"probe_{name}")
        path = root / "cfg.yaml"
        path.write_text(yaml.safe_dump(dict(PROBE, **over)))
        jcfg = jax_parse_config(["--base_config", str(path)])
        jdir = root / "jax"
        jserving.export_probing_artifact(jcfg, jdir, max_batch=MAX_BATCH)
        cfg = parse_config(["--base_config", str(path), "--use_pallas_attention", "true"])
        bundle, _ = probe_train.build_probe_bundle(cfg, device="cpu")
        convert.load_probe_tree(_tree(jdir), bundle.video_model, bundle.mil_model)
        params = probe_train.probe_params(bundle.video_model, bundle.mil_model)
        tdir = root / "port"
        meta = serving.export_probing_artifact(cfg, tdir, max_batch=MAX_BATCH,
                                               probe_params=params, device="cpu")
        out[name] = dict(jcfg=jcfg, jdir=jdir, jart=jserving.ProbingArtifact(jdir), cfg=cfg,
                         cfg_path=path, bundle=bundle, params=params, tdir=tdir, meta=meta,
                         art=serving.ProbingArtifact(tdir, device="cpu"))
    return out


def _probe_args(p, b):
    st, mask = _studies(p["meta"], b)
    return (st, mask, _view_ids(p["meta"], b) if p["meta"]["has_view_ids"] else None)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("reference", ["jax_artifact", "jax_probing_fn"])
def test_probing_matches_jax(probing, variant, reference):
    p = probing[variant]
    st, mask, vid = _probe_args(p, MAX_BATCH)
    got = p["art"].infer_batch(st, mask, vid)
    if reference == "jax_artifact":
        want = p["jart"].infer_batch(st, mask, vid)
    else:
        m = p["meta"]
        fn = jax.jit(jserving._probing_fn(
            jax_video_encoder(p["jcfg"], aggregate=False, per_video=not m["hierarchical_tokens"]),
            jax_mil(p["jcfg"]), m["hierarchical_tokens"], m["has_view_ids"]))
        args = [p["jart"]._params, jnp.asarray(st), jnp.asarray(mask)]
        if vid is not None:
            args.append(jnp.asarray(vid))
        want = {h: np.asarray(v) for h, v in fn(*args).items()}
    assert sorted(got) == sorted(want) == ["cto", "stenosis", "vessel"]
    for h in want:
        assert got[h].shape == want[h].shape
        np.testing.assert_allclose(got[h], want[h], atol=ATOL, err_msg=h)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_probing_bit_equal_to_forward_heads(probing, variant):
    """The artifact against the runner's forward on the same bundle, and a
    short batch's rows against the full batch's."""
    p = probing[variant]
    st, mask, vid = _probe_args(p, MAX_BATCH)
    got = p["art"].infer_batch(st, mask, vid)
    batch = {"videos": torch.from_numpy(st), "video_mask": torch.from_numpy(mask)}
    if vid is not None:
        batch["view_ids"] = torch.from_numpy(vid)
    with torch.no_grad():
        want, _ = probe_train.forward_heads(p["bundle"], batch)
    solo = p["art"].infer_batch(st[:1], mask[:1], None if vid is None else vid[:1])
    for h in want:
        np.testing.assert_array_equal(got[h], want[h].numpy())
        np.testing.assert_array_equal(solo[h], got[h][:1])


def test_probing_meta_and_predict(probing):
    p = probing["view_ids"]
    meta = p["meta"]
    jmeta = json.loads((p["jdir"] / jserving.META_FILE).read_text())
    assert set(meta) == (set(jmeta) - {"jax_version"}) | {
        "torch_version", "cuda_arch", "ops", "kernels", "fused_outproj"}
    for k in set(jmeta) - {"jax_version", "platforms"}:
        assert meta[k] == jmeta[k], k
    # the backbone's block (K1: the switch is off), the head's CLS block (K3)
    assert meta["kernels"] == {"K1": 1, "K3": 1} and meta["fused_outproj"] is False
    st, mask, vid = _probe_args(p, 1)
    logits = p["art"].infer_batch(st, mask, vid)
    probs = p["art"].predict(st, mask, vid)
    np.testing.assert_allclose(probs["cto"], 1 / (1 + np.exp(-logits["cto"])), rtol=1e-6)
    np.testing.assert_allclose(probs["vessel"].sum(-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(probs["stenosis"], logits["stenosis"])
    jprobs = p["jart"].predict(st, mask, vid)
    for h in probs:
        np.testing.assert_allclose(probs[h], jprobs[h], atol=ATOL, err_msg=h)


def test_probing_fused_projection(probing, tmp_path):
    """``fused_outproj``: the backbone's blocks call K5's operator; the
    logits agree with the unfused artifact's (the projection rounds once
    inside the kernel's plain version too) and with the bundle built so."""
    p = probing["plain"]
    meta = serving.export_probing_artifact(p["cfg"], tmp_path, max_batch=MAX_BATCH,
                                           probe_params=p["params"], device="cpu",
                                           fused_outproj=True)
    assert meta["fused_outproj"] is True and meta["kernels"] == {"K3": 1, "K5": 1}
    assert meta["ops"] == {"deepcoro::attention": 1, "deepcoro::attention_proj": 1}
    art = serving.ProbingArtifact(tmp_path, device="cpu")
    st, mask, _ = _probe_args(p, MAX_BATCH)
    got, ref = art.infer_batch(st, mask), p["art"].infer_batch(st, mask)
    bundle, _ = probe_train.build_probe_bundle(p["cfg"], device="cpu", fused_outproj=True)
    bundle.video_model.load_state_dict(p["bundle"].video_model.state_dict())
    bundle.mil_model.load_state_dict(p["bundle"].mil_model.state_dict())
    with torch.no_grad():
        want, _ = probe_train.forward_heads(bundle, {"videos": torch.from_numpy(st),
                                                     "video_mask": torch.from_numpy(mask)})
    for h in ref:
        np.testing.assert_allclose(got[h], ref[h], atol=ATOL, err_msg=h)
        np.testing.assert_array_equal(got[h], want[h].numpy())


# --------------------------------------------------------------------------- #
# the operators


def _qkv(B, H, L, Dh, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, L, Dh, generator=g) for _ in range(3)]


@pytest.mark.parametrize("layout", ["heads", "packed", "fused"])
@pytest.mark.parametrize("mode", ["mask", "causal", "rope"])
def test_operator_cpu_kernel_is_the_plain_version(layout, mode):
    """``deepcoro::attention`` on CPU tensors equals ``multi_head_attention``
    bit for bit in every layout; ``deepcoro::attention_proj`` equals it
    followed by ``project_plain``; the fake kernels give the shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    B, H, L, Dh = 2, 2, 9, 16
    q, k, v = _qkv(B, H, L, Dh, 3)
    mask = torch.ones(B, L, dtype=torch.bool)
    mask[1, 5:] = False
    sin = cos = kv = None
    causal = mode == "causal"
    if mode == "mask":
        kv = mask
    if mode == "rope":
        t = build_rope3d_tables(Dh, 2, 2, 2, n_special=1)
        sin, cos = torch.from_numpy(t.sin), torch.from_numpy(t.cos)
    want = multi_head_attention(q, k, v, sin=sin, cos=cos, kv_mask=kv, causal=causal,
                                scale=0.3)
    packed = [t.transpose(1, 2).flatten(2) for t in (q, k, v)]
    if layout == "heads":
        args, ref = (q, k, v), want
    else:
        ref = want.transpose(1, 2).flatten(2)
        args = (torch.cat(packed, -1), None, None) if layout == "fused" else packed
    got = torch.ops.deepcoro.attention(*args, sin, cos, kv, causal, 0.3, layout, H)
    assert torch.equal(got, ref)
    with FakeTensorMode() as mode_:
        fake = torch.ops.deepcoro.attention(*(mode_.from_tensor(a) if a is not None else None
                                              for a in args), None, None, None, causal, 0.3,
                                            layout, H)
    assert tuple(fake.shape) == tuple(ref.shape) and fake.dtype == ref.dtype
    if layout != "heads":
        wo = torch.randn(H * Dh, 24, generator=torch.Generator().manual_seed(5))
        y = torch.ops.deepcoro.attention_proj(*args, wo, sin, cos, kv, causal, 0.3, layout, H)
        assert torch.equal(y, project_plain(ref, wo)) and y.shape == (B, L, 24)


def test_no_grad_calls_go_through_the_operators(monkeypatch):
    """The entry points' no-grad calls reach the operators (so that a trace
    keeps them); a call that wants a gradient does not."""
    seen = []
    for name in ("attention", "attention_proj"):
        op = getattr(torch.ops.deepcoro, name).default

        def spy(*a, _op=op, _name=name):
            seen.append(_name)
            return _op(*a)

        from deepcoro_clip_tpu_torch.ops import library
        monkeypatch.setattr(library, name, spy)
    q, k, v = _qkv(1, 2, 5, 128, 1)
    with torch.no_grad():
        flash_attention(q, k, v)
        flash_attention_packed(qkv=torch.cat([t.transpose(1, 2).flatten(2) for t in (q, k, v)],
                                             -1), num_heads=2, wo=torch.randn(256, 128))
    assert seen == ["attention", "attention_proj"]
    flash_attention(q.requires_grad_(), k, v)
    assert seen == ["attention", "attention_proj"]


def test_opcheck():
    """torch.library's own checks of the operators' registrations (schema,
    fake kernel against the real one, dispatch)."""
    q, k, v = _qkv(2, 2, 6, 16, 2)
    mask = torch.tensor([[1, 1, 1, 0, 0, 0], [1] * 6], dtype=torch.bool)
    torch.library.opcheck(torch.ops.deepcoro.attention.default,
                          (q, k, v, None, None, mask, False, 0.25, "heads", 2),
                          test_utils=("test_schema", "test_faketensor"))
    packed = torch.cat([t.transpose(1, 2).flatten(2) for t in (q, k, v)], -1)
    torch.library.opcheck(torch.ops.deepcoro.attention_proj.default,
                          (packed, None, None, torch.randn(32, 8), None, None, mask, True,
                           0.25, "fused", 2),
                          test_utils=("test_schema", "test_faketensor"))


# --------------------------------------------------------------------------- #
# the entry points


def test_export_model_retrieval_subcommands(retrieval, tmp_path, capsys):
    """``export`` from a port checkpoint and a bank, ``run``, ``verify``."""
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
    from deepcoro_clip_tpu_torch.train.state import TrainState

    ck = tmp_path / "run" / "checkpoints"
    params = {f"video_encoder.{k}": v for k, v in retrieval["sd"].items()}
    params["log_temp"] = torch.zeros(())
    CheckpointManager(ck).save_latest(TrainState(step=1, params=params, opt_state={}), {})
    bank = tmp_path / "bank.npz"
    np.savez(bank, text_embeddings=retrieval["bank"], texts=np.asarray(retrieval["texts"]))
    out = tmp_path / "art"
    cfg_path = tmp_path / "clip.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(retrieval["cfg"].to_dict(),
                                            pipeline_project="DeepCORO_clip")))
    meta = export_model.main(["export", "--out", str(out), "--base_config", str(cfg_path),
                              "--checkpoint", str(ck), "--text_bank", str(bank),
                              "--num_videos", str(NUM_VIDEOS), "--max_batch", str(MAX_BATCH),
                              "--top_k", str(TOP_K), "--device", "cpu"])
    assert meta["kernels"] == {"K1": 1, "K3": 1} and meta["bank_size"] == BANK
    assert torch.load(out / serving.PARAMS_FILE, weights_only=True).keys() == \
        retrieval["sd"].keys()
    st, mask = _studies(meta, MAX_BATCH)
    for a, b in zip(serving.RetrievalArtifact(out, device="cpu").infer_batch(st, mask),
                    retrieval["art"].infer_batch(st, mask)):
        np.testing.assert_array_equal(a, b)
    clips = []
    for i in range(2):
        clips.append(str(tmp_path / f"c{i}.npy"))
        np.save(clips[-1], np.random.default_rng(i).integers(0, 256, (6, 40, 40, 3),
                                                             dtype=np.uint8))
    body = export_model.main(["run", "--artifact", str(out), "--videos", *clips,
                              "--device", "cpu"])
    assert len(body["topk"]) == TOP_K and body["topk"][0]["text"] in retrieval["texts"]
    ok = export_model.main(["verify", "--artifact", str(out), "--base_config", str(cfg_path),
                            "--num_videos", str(NUM_VIDEOS), "--device", "cpu"])
    assert ok["ok"] and ok["max_abs_emb"] == 0.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["ok"] is True


def test_export_model_probing_subcommands(probing, tmp_path):
    """``export-probe`` from a port probing checkpoint (the whole state),
    ``run`` (head predictions), ``verify``."""
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
    from deepcoro_clip_tpu_torch.train.state import TrainState

    p = probing["view_ids"]
    ck = tmp_path / "probe" / "checkpoints"
    CheckpointManager(ck).save_latest(TrainState(step=1, params=p["params"], opt_state={}),
                                      {})
    out = tmp_path / "art"
    common = ["--base_config", str(p["cfg_path"]), "--use_pallas_attention", "true"]
    meta = export_model.main(["export-probe", "--out", str(out), *common, "--checkpoint",
                              str(ck), "--max_batch", str(MAX_BATCH), "--device", "cpu"])
    assert meta["kind"] == "probing" and meta["has_view_ids"]
    st, mask, vid = _probe_args(p, MAX_BATCH)
    got = serving.ProbingArtifact(out, device="cpu").infer_batch(st, mask, vid)
    for h, v in p["art"].infer_batch(st, mask, vid).items():
        np.testing.assert_array_equal(got[h], v)
    body = export_model.main(["run", "--artifact", str(out), "--device", "cpu"])
    assert sorted(body["predictions"]) == ["cto", "stenosis", "vessel"]
    assert len(body["predictions"]["vessel"]) == 3
    ok = export_model.main(["verify", "--artifact", str(out), *common, "--device", "cpu"])
    assert ok["ok"] and ok["max_abs_logit"] == 0.0


def test_artifact_loads_without_the_model_classes(retrieval):
    """A fresh process that imports only ``serving`` loads the artifact and
    answers as this one does; no model module is imported on that path."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "from deepcoro_clip_tpu_torch.serving import RetrievalArtifact\n"
        f"a = RetrievalArtifact({str(retrieval['tdir'])!r}, device='cpu')\n"
        "r = np.random.default_rng(1)\n"
        "st = r.integers(0, 256, (1, a.num_videos, a.meta['tokens_per_clip'], "
        "a.meta['patch_bytes']), dtype=np.uint8)\n"
        "emb, scores, idx = a.infer_batch(st, np.ones((1, a.num_videos), bool))\n"
        "np.save(sys.argv[1], emb)\n"
        "print(sorted(m for m in sys.modules if m.startswith('deepcoro_clip_tpu_torch.models')))\n")
    out = retrieval["tdir"].parent / "fresh_emb.npy"
    proc = subprocess.run([sys.executable, "-c", code, str(out)], capture_output=True,
                          text=True, timeout=300, cwd=str(Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    st = np.random.default_rng(1).integers(
        0, 256, (1, NUM_VIDEOS, retrieval["meta"]["tokens_per_clip"],
                 retrieval["meta"]["patch_bytes"]), dtype=np.uint8)
    np.testing.assert_array_equal(
        np.load(out), retrieval["art"].infer_batch(st, np.ones((1, NUM_VIDEOS), bool))[0])


def test_serve_from_the_artifact_over_http(retrieval, tmp_path):
    args = serve.parse_args(["--artifact", str(retrieval["tdir"]), "--port", "0",
                             "--batch_window_ms", "20", "--device", "cpu"])
    httpd, engine = serve.build_server(args)
    assert isinstance(engine, serving.RetrievalArtifact)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        paths = []
        for i in range(2):
            paths.append(str(tmp_path / f"clip{i}.npy"))
            np.save(paths[-1], np.random.default_rng(i).integers(0, 256, (8, 48, 48, 3),
                                                                 dtype=np.uint8))

        def req(method, path, payload=None):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            c.request(method, path, None if payload is None else json.dumps(payload),
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            return r.status, json.loads(r.read())

        code, out = req("POST", "/retrieve", {"videos": paths})
        assert code == 200 and len(out["topk"]) == TOP_K and out["n_clips"] == 2
        study, mask = engine.load_study(paths)
        emb, scores, idx = engine.infer_batch(study[None], mask[None])
        assert [t["text"] for t in out["topk"]] == [retrieval["texts"][j] for j in idx[0]]
        code, out = req("POST", "/embed", {"videos": paths[:1]})
        assert code == 200 and abs(np.linalg.norm(out["embedding"]) - 1) < 1e-5
        code, stats = req("GET", "/stats")
        assert code == 200 and stats["requests"] == 2 and stats["bank_size"] == BANK
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_entry_points_default_to_cuda(retrieval, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.RetrievalArtifact(retrieval["tdir"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.export_retrieval_artifact(retrieval["cfg"], tmp_path, retrieval["bank"],
                                          retrieval["texts"])
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.main(["run", "--artifact", str(retrieval["tdir"])])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_server(serve.parse_args(["--artifact", str(retrieval["tdir"]),
                                             "--port", "0"]))
