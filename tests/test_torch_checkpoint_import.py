"""The port's reference-checkpoint importers against the JAX package's.

A reference-named checkpoint is built from a numpy seed: the text tower
(``bert.*`` with the pooler, the token-type table and the ``position_ids``
buffer, and the ``proj.1`` head), the video encoder (the projection head,
the ``EnhancedVideoAggregator``, the ``AttentionPool`` and ``model.*``
mVIT keys the converters skip), the MIL head, the captioning decoder,
optimizer and scheduler state, an unmapped component and scalar metadata.

- ``utils/torch_import.convert_reference_checkpoint`` of the port against
  the JAX one followed by ``convert.jax_tree_to_state_dict``: the same
  keys and the same bits for every component, the same report.
- The forwards of the port's modules loaded with the port's states against
  the JAX modules with the JAX trees, fp32, within 1e-5.
- The CLI (``python -m deepcoro_clip_tpu_torch.convert_checkpoint``) on a
  temporary file: what it prints, the report it writes, and a file that
  ``load_converted`` reads back equal.
- ``hf_import.bert_state_dict_to_port`` with and without the ``bert.``
  prefix and the token-type table, against the JAX
  ``bert_state_dict_to_flax``; ``load_pubmedbert_into`` keeps the head.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcoro_clip_tpu.models.attention_pool import AttentionPool as JPool
from deepcoro_clip_tpu.models.captioning_decoder import CaptioningDecoder as JDecoder
from deepcoro_clip_tpu.models.mil import MultiInstanceLinearProbing as JMil
from deepcoro_clip_tpu.models.text_encoder import TextEncoder as JText
from deepcoro_clip_tpu.models.video_aggregator import EnhancedVideoAggregator as JAgg
from deepcoro_clip_tpu.utils import hf_import as jhf
from deepcoro_clip_tpu.utils import torch_import as jimport

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.models.attention_pool import AttentionPool
from deepcoro_clip_tpu_torch.models.captioning_decoder import CaptioningDecoder
from deepcoro_clip_tpu_torch.models.mil import MultiInstanceLinearProbing
from deepcoro_clip_tpu_torch.models.text_encoder import TextEncoder
from deepcoro_clip_tpu_torch.models.video_aggregator import EnhancedVideoAggregator
from deepcoro_clip_tpu_torch.utils import hf_import, torch_import

TOL = dict(rtol=1e-5, atol=1e-5)
V, TD, TDEPTH, THEADS, TMLP, TPOS, E = 96, 32, 2, 2, 64, 16, 16  # text tower
D, HEADS, SEG, ADEPTH = 32, 4, 64, 2  # video side
HEADS_MIL, HIDDEN = {"stenosis": 3, "ifr": 1}, 24
CV, CD, CDEPTH, CHEADS, CLEN = 80, 32, 2, 4, 12  # captioning decoder
COMPONENTS = ("text_encoder", "video_encoder", "linear_probing", "captioning_decoder")


def _rng(seed):
    r = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy((0.2 * r.standard_normal(shape)).astype(np.float32))

    return t


def _ln(t, prefix, d):
    return {f"{prefix}.weight": 1.0 + t(d), f"{prefix}.bias": t(d)}


def _linear(t, prefix, dout, din, bias=True):
    out = {f"{prefix}.weight": t(dout, din)}
    if bias:
        out[f"{prefix}.bias"] = t(dout)
    return out


def _mha(t, prefix, d):
    return {f"{prefix}.in_proj_weight": t(3 * d, d), f"{prefix}.in_proj_bias": t(3 * d),
            **_linear(t, f"{prefix}.out_proj", d, d)}


def bert_sd(seed=0, prefix="bert.", token_type=True):
    t = _rng(seed)
    sd = {"embeddings.word_embeddings.weight": t(V, TD),
          "embeddings.position_embeddings.weight": t(TPOS, TD),
          "embeddings.position_ids": torch.arange(TPOS)[None],
          **_ln(t, "embeddings.LayerNorm", TD),
          **_linear(t, "pooler.dense", TD, TD)}
    if token_type:
        sd["embeddings.token_type_embeddings.weight"] = t(2, TD)
    for i in range(TDEPTH):
        b = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd.update(_linear(t, f"{b}.attention.self.{name}", TD, TD))
        sd.update(_linear(t, f"{b}.attention.output.dense", TD, TD))
        sd.update(_ln(t, f"{b}.attention.output.LayerNorm", TD))
        sd.update(_linear(t, f"{b}.intermediate.dense", TMLP, TD))
        sd.update(_linear(t, f"{b}.output.dense", TD, TMLP))
        sd.update(_ln(t, f"{b}.output.LayerNorm", TD))
    return {prefix + k: v for k, v in sd.items()}


def aggregator_sd(t):
    sd = {"pos_encoding": t(1, SEG, D), "attn_query": t(1, 1, D), **_ln(t, "final_ln", D)}
    for i in range(ADEPTH):
        p = f"blocks.{i}"
        sd.update(_ln(t, f"{p}.norm1", D))
        sd.update(_ln(t, f"{p}.norm2", D))
        sd.update(_mha(t, f"{p}.attn", D))
        sd.update(_linear(t, f"{p}.mlp.0", 4 * D, D))
        sd.update(_linear(t, f"{p}.mlp.3", D, 4 * D))
    return sd


def pool_sd(t, cls_variant=False):
    if cls_variant:  # AttentionPoolWithCLS: a cls token and blocks, no query
        return {"cls_token": t(1, 1, D), **_mha(t, "blocks.0.attn", D)}
    return {"query": t(1, 1, D), **_mha(t, "attn", D), **_ln(t, "norm", D)}


def video_sd(seed=1, cls_variant=False):
    t = _rng(seed)
    sd = {"model.blocks.0.attn.qkv.weight": t(24, 8), "model.blocks.0.attn.qkv.bias": t(24),
          "model.patch_embed.proj.weight": t(8, 3, 2, 4, 4),
          **_linear(t, "proj.1", E, D)}
    sd.update({f"aggregator.{k}": v for k, v in aggregator_sd(t).items()})
    sd.update({f"attention_pool.{k}": v for k, v in pool_sd(t, cls_variant).items()})
    return sd


def mil_sd(seed=2):
    t = _rng(seed)
    sd = {}
    for h, n in HEADS_MIL.items():
        sd.update(_linear(t, f"heads.{h}", n, D))
    sd.update(_linear(t, "attention_V", HIDDEN, D))
    sd.update(_linear(t, "attention_U", HIDDEN, D))
    sd.update(_linear(t, "attention_w", 1, HIDDEN))
    return sd


def decoder_sd(seed=3):
    t = _rng(seed)
    sd = {"token_embeddings.weight": t(CV, CD), "position_embeddings.weight": t(CLEN, CD),
          **_ln(t, "embedding_layer_norm", CD), **_ln(t, "final_layer_norm", CD),
          "lm_head.weight": t(CV, CD)}
    for i in range(CDEPTH):
        p = f"decoder_layers.{i}"
        for ln in ("self_attention_layer_norm", "cross_attention_layer_norm",
                   "feed_forward_layer_norm"):
            sd.update(_ln(t, f"{p}.{ln}", CD))
        sd.update(_mha(t, f"{p}.self_attention", CD))
        sd.update(_mha(t, f"{p}.cross_attention", CD))
        sd.update(_linear(t, f"{p}.intermediate", 4 * CD, CD))
        sd.update(_linear(t, f"{p}.output", CD, 4 * CD))
    return sd


def reference_checkpoint():
    t = _rng(9)
    text = bert_sd()
    text.update(_linear(t, "proj.1", E, TD))
    return {
        "epoch": 7, "best_val_loss": 0.625, "run_name": "ref",
        "text_encoder": text,
        "video_encoder": video_sd(),
        "linear_probing": mil_sd(),
        "captioning_decoder": decoder_sd(),
        "optimizer": {"state": {0: {"exp_avg": t(3)}}, "param_groups": [{"lr": 1e-3}]},
        "scheduler": {"last_epoch": 3, "base_lrs": [1e-3]},
        "ema_shadow": {"w": t(4)},
        "empty": {},
    }


@pytest.fixture(scope="module")
def converted():
    ckpt = reference_checkpoint()
    jtrees, jreport = jimport.convert_reference_checkpoint(ckpt)
    states, report = torch_import.convert_reference_checkpoint(ckpt)
    return ckpt, jtrees, jreport, states, report


@pytest.mark.parametrize("component", COMPONENTS)
def test_states_bit_equal_to_jax_then_convert(converted, component):
    """The port's importer against the JAX importer followed by
    ``convert.jax_tree_to_state_dict``: the same keys, dtypes and bits."""
    _, jtrees, _, states, _ = converted
    want = convert.jax_tree_to_state_dict(jtrees[component])
    got = states[component]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], w), k


def test_report_matches_jax(converted):
    """Converted and skipped components, the skipped counts (the mVIT
    backbone's 3 tensors, the optimizer, the scheduler, the unmapped
    component) and the metadata."""
    _, _, jreport, _, report = converted
    assert report == jreport
    assert report["converted"] == ["text_encoder", "video_encoder (partial)",
                                   "linear_probing", "captioning_decoder"]
    assert report["skipped"] == {
        "video_encoder.model (mVIT backbone — no CoroViT mapping)": 3,
        "optimizer": 2, "scheduler": 2, "ema_shadow (no mapping)": 1}
    assert report["meta"] == {"epoch": 7, "best_val_loss": 0.625, "run_name": "ref"}


def test_with_cls_pool_is_skipped_as_in_jax():
    """A ``WithCLS`` attention pool has no mapping: both importers leave it
    out and count its tensors."""
    sd = video_sd(cls_variant=True)
    jtree, jskipped = jimport.video_encoder_partial_to_flax(jimport.numpy_state_dict(sd))
    state, skipped = torch_import.video_encoder_partial_to_port(sd)
    assert skipped == jskipped
    assert skipped["attention_pool (WithCLS variant — documented divergence)"] == 5
    assert not any(k.startswith("pool.") for k in state)
    want = convert.jax_tree_to_state_dict(jtree)
    assert sorted(state) == sorted(want)
    assert all(torch.equal(state[k], want[k]) for k in want)


def _jax_apply(module, tree, *args, **kw):
    return jax.tree_util.tree_map(np.asarray, module.apply({"params": tree}, *args, **kw))


def _load(module, state, strict=True):
    missing, unexpected = module.load_state_dict(state, strict=strict)
    assert not unexpected
    return module.eval()


def test_text_tower_forward_matches_jax(converted):
    _, jtrees, _, states, _ = converted
    r = np.random.default_rng(0)
    ids = r.integers(0, V, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    jm = JText(embedding_dim=E, vocab_size=V, dim=TD, depth=TDEPTH, num_heads=THEADS,
               mlp_dim=TMLP, max_positions=TPOS, dropout=0.0, proj_dropout=0.0,
               dtype=jnp.float32, use_flash=False)
    want = _jax_apply(jm, jtrees["text_encoder"], jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask))
    tm = _load(TextEncoder(embedding_dim=E, vocab_size=V, dim=TD, depth=TDEPTH,
                           num_heads=THEADS, mlp_dim=TMLP, max_positions=TPOS,
                           dropout=0.0, proj_dropout=0.0, dtype=torch.float32,
                           use_flash=False), states["text_encoder"])
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_aggregator_and_pool_forwards_match_jax(converted):
    _, jtrees, _, states, _ = converted
    r = np.random.default_rng(1)
    x = r.standard_normal((3, 5, D)).astype(np.float32)
    toks = r.standard_normal((3, 7, D)).astype(np.float32)
    video = states["video_encoder"]
    ja = JAgg(dim=D, num_heads=HEADS, depth=ADEPTH, dropout=0.0, max_segments=SEG,
              dtype=jnp.float32, use_flash=False)
    want = _jax_apply(ja, jtrees["video_encoder"]["aggregator"], jnp.asarray(x),
                      deterministic=True)
    ta = _load(EnhancedVideoAggregator(D, HEADS, ADEPTH, 0.0, SEG, torch.float32, False),
               {k[len("aggregator."):]: v for k, v in video.items()
                if k.startswith("aggregator.")})
    with torch.no_grad():
        got = ta(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jp = JPool(dim=D, num_heads=HEADS, dropout=0.0, dtype=jnp.float32, use_flash=False)
    want = _jax_apply(jp, jtrees["video_encoder"]["pool"], jnp.asarray(toks),
                      deterministic=True)
    tp = _load(AttentionPool(D, HEADS, 0.0, torch.float32, use_flash=False),
               {k[len("pool."):]: v for k, v in video.items() if k.startswith("pool.")})
    with torch.no_grad():
        got = tp(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mil_head_forward_matches_jax(converted):
    _, jtrees, _, states, _ = converted
    x = np.random.default_rng(2).standard_normal((3, 5, D)).astype(np.float32)
    kw = dict(embedding_dim=D, head_structure=HEADS_MIL, pooling_mode="attention",
              attention_hidden=HIDDEN, dropout=0.0, dropout_attention=0.0,
              separate_video_attention=False)
    want = _jax_apply(JMil(**kw, dtype=jnp.float32), jtrees["linear_probing"],
                      jnp.asarray(x), deterministic=True)
    tm = _load(MultiInstanceLinearProbing(**kw, dtype=torch.float32),
               states["linear_probing"])
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert set(got) >= set(HEADS_MIL)
    for h in HEADS_MIL:
        np.testing.assert_allclose(got[h].numpy(), want[h], err_msg=h, **TOL)


def test_captioning_decoder_forward_matches_jax(converted):
    _, jtrees, _, states, _ = converted
    r = np.random.default_rng(3)
    ids = r.integers(0, CV, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    mask[0, 5:] = 0
    mem = r.standard_normal((2, 6, CD)).astype(np.float32)
    kw = dict(vocab_size=CV, dim=CD, depth=CDEPTH, num_heads=CHEADS, max_length=CLEN,
              memory_dim=CD, dropout=0.0, use_flash=False)
    want = _jax_apply(JDecoder(**kw, dtype=jnp.float32), jtrees["captioning_decoder"],
                      jnp.asarray(ids), jnp.asarray(mem), attention_mask=jnp.asarray(mask))
    tm = _load(CaptioningDecoder(**kw, dtype=torch.float32), states["captioning_decoder"])
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mem),
                 attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cli_round_trip(tmp_path):
    """The CLI on a ``torch.save`` file: its lines, its report, and a file
    that ``load_converted`` reads back equal to the importer's states."""
    ckpt = reference_checkpoint()
    src, out, rep = tmp_path / "ref.pt", tmp_path / "converted.pt", tmp_path / "r.json"
    torch.save(ckpt, src)
    proc = subprocess.run(
        [sys.executable, "-m", "deepcoro_clip_tpu_torch.convert_checkpoint", str(src),
         "--out", str(out), "--report", str(rep)], capture_output=True, text=True,
        check=True)
    lines = proc.stdout.splitlines()
    assert lines[0] == f"wrote {out}"
    assert lines[1] == ("converted: text_encoder, video_encoder (partial), linear_probing, "
                        "captioning_decoder")
    assert "skipped:   video_encoder.model (mVIT backbone — no CoroViT mapping) (3 tensors)" \
        in lines
    assert "skipped:   optimizer (2 tensors)" in lines
    assert lines[-1] == ('metadata:  {"epoch": 7, "best_val_loss": 0.625, '
                         '"run_name": "ref"}')
    states, report = torch_import.convert_reference_checkpoint(ckpt)
    assert json.loads(rep.read_text()) == json.loads(json.dumps(report))
    back = torch_import.load_converted(str(out))
    assert sorted(back) == sorted(states)
    for c, sd in states.items():
        assert sorted(back[c]) == sorted(sd)
        assert all(torch.equal(back[c][k], sd[k]) for k in sd), c


def test_cli_without_a_convertible_component(tmp_path, capsys):
    from deepcoro_clip_tpu_torch import convert_checkpoint

    src = tmp_path / "opt.pt"
    torch.save({"epoch": 1, "optimizer": {"state": {}}}, src)
    assert convert_checkpoint.main([str(src), "--out", str(tmp_path / "o.pt")]) == 1
    assert "nothing convertible" in capsys.readouterr().out
    assert not (tmp_path / "o.pt").exists()


@pytest.mark.parametrize("prefix", ["bert.", ""])
@pytest.mark.parametrize("token_type", [True, False])
def test_bert_state_dict_to_port_matches_jax(prefix, token_type):
    """With or without the ``bert.`` prefix and the token-type table (its
    row 0 folded into the positions): the JAX tree after
    ``convert.jax_tree_to_state_dict``, bit for bit, and no pooler."""
    sd = bert_sd(seed=4, prefix=prefix, token_type=token_type)
    want = convert.jax_tree_to_state_dict(jhf.bert_state_dict_to_flax(
        {k: v.numpy() for k, v in sd.items()}, depth=TDEPTH))
    got = hf_import.bert_state_dict_to_port(sd, depth=TDEPTH)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    pos = sd[prefix + "embeddings.position_embeddings.weight"]
    if token_type:
        pos = pos + sd[prefix + "embeddings.token_type_embeddings.weight"][0]
    assert torch.equal(got["position_embeddings"], pos)
    assert not any("pooler" in k for k in got)


def test_load_pubmedbert_into_keeps_the_head(tmp_path):
    """A BERT checkpoint merged into a text tower's state: the body is the
    checkpoint's, the projection head the tower's own, and the result loads
    strictly."""
    tm = TextEncoder(embedding_dim=E, vocab_size=V, dim=TD, depth=TDEPTH, num_heads=THEADS,
                     mlp_dim=TMLP, max_positions=TPOS, dtype=torch.float32, use_flash=False)
    torch.nn.init.normal_(tm.proj.proj.weight)
    path = tmp_path / "bert.pt"
    torch.save(bert_sd(seed=5), path)
    merged = hf_import.load_pubmedbert_into(tm.state_dict(), str(path), depth=TDEPTH)
    tm.load_state_dict(merged, strict=True)
    assert torch.equal(tm.proj.proj.weight, merged["proj.proj.weight"])
    assert torch.equal(tm.layer1.output.weight,
                       bert_sd(seed=5)["bert.encoder.layer.1.output.dense.weight"])
