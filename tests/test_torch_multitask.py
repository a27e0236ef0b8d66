"""The port's multitask pipeline against the JAX package, on the CPU: the
config, the train and eval steps, the runner per epoch, resume.

The JAX bundle's initial tree goes through ``deepcoro_clip_tpu_torch.convert``
into the port's four models; both take the same seeded numpy batch. The JAX
side runs its XLA attention, the port's side its kernel wrappers, whose
plain versions run on CPU tensors. The text head's ``proj_dropout``, which
no config field reaches, is set to 0 on both sides.

The JAX package draws the MVM mask and the dropout masks from
``jax.random``, which torch cannot reproduce (a deliberate divergence): the
step tests hand the port the JAX step's mask (``fold_in(rng, 1)``), the
runner parity runs at dropout 0 with ``loss_weights.mvm: 0`` and compares
everything but the MVM term.

Tolerances, stated at each test: fp32 values rtol 1e-4 (fp32 sums in
another order); parameters after an update atol 3e-5; caption metrics
exact.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs import MultitaskConfig as JaxMultitaskConfig
from deepcoro_clip_tpu.configs.parser import parse_config as jax_parse_config
from deepcoro_clip_tpu.models import masked_video_modeling as jmvm
from deepcoro_clip_tpu.parallel import MeshSpec, make_mesh
from deepcoro_clip_tpu.registry import register_all as jax_register_all
from deepcoro_clip_tpu.runners.multitask import MultitaskRunner as JaxRunner
from deepcoro_clip_tpu.train import multitask as jmt

from deepcoro_clip_tpu_torch import configs as tconfigs
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
from deepcoro_clip_tpu_torch.runners import multitask as trun
from deepcoro_clip_tpu_torch.train import multitask as tmt

jax_register_all()

REPO = Path(__file__).resolve().parents[1]
FP32 = dict(rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# config


def test_multitask_yamls_parse_as_in_jax():
    """Both shipped multitask YAMLs: the port's MultitaskConfig has every
    JAX field, in order, with the JAX value (but the device fields, which
    each package fills from its own devices)."""
    device = {"is_ref_device", "process_index", "process_count", "world_size"}
    jfields = list(JaxMultitaskConfig.__dataclass_fields__)
    tfields = [f for f in tconfigs.MultitaskConfig.__dataclass_fields__
               if f not in tconfigs.PORT_FIELDS]
    assert tfields == jfields
    for path in sorted((REPO / "config" / "multitask").glob("*.yaml")):
        j = jax_parse_config(["--base_config", str(path)])
        t = tconfigs.parse_config(["--base_config", str(path)])
        assert type(t) is tconfigs.MultitaskConfig, path
        for name in set(jfields) - device:
            assert getattr(t, name) == getattr(j, name), (path.name, name)
        assert tconfigs.unported_settings(t) == []


def test_chip_smoke_multitask_config_is_the_yaml():
    """``chip_smoke.multitask_config()`` spells out the YAML (the card
    machine need not have a YAML reader)."""
    import chip_smoke

    t = tconfigs.parse_config(["--base_config",
                               str(REPO / "config/multitask/multitask_config.yaml")])
    c = chip_smoke.multitask_config()
    for name in tconfigs.MultitaskConfig.__dataclass_fields__:
        assert getattr(c, name) == getattr(t, name), name


def test_clip_yaml_with_locca_still_raises(tmp_path):
    """A DeepCORO_clip YAML with ``locca_enabled`` raised until the
    contrastive path's LocCa head was ported: it now passes
    ``check_ported`` and builds the head over the video tokens, as the
    multitask config does its decoder. What still raises is a head whose
    token grid does not tile the backbone's tokens."""
    raw = yaml.safe_load((REPO / "config/clip/base_config.yaml").read_text())
    raw["locca_enabled"] = True
    p = tmp_path / "clip_locca.yaml"
    p.write_text(yaml.safe_dump(raw))
    cfg = tconfigs.parse_config(["--base_config", str(p)])
    assert cfg.locca_enabled and tconfigs.unported_settings(cfg) == []
    from deepcoro_clip_tpu_torch.models.locca_decoder import locca_decoder_from_config
    from deepcoro_clip_tpu_torch.runners.contrastive import check_ported

    check_ported(cfg)
    dec = locca_decoder_from_config(cfg, memory_dim=cfg.embedding_dim)
    assert (dec.dim, dec.depth, dec.num_heads, dec.max_length) == (
        cfg.locca_d_model, cfg.locca_num_layers, cfg.locca_num_heads, cfg.locca_max_seq_len)
    n_tok = dec.coords.shape[0]
    with torch.no_grad():
        out = dec(torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 2 * n_tok, cfg.embedding_dim))
        assert out.shape == (1, 4, cfg.text_vocab_size)
        with pytest.raises(ValueError, match="not a multiple"):
            dec(torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, n_tok + 1, cfg.embedding_dim))
    mt = tconfigs.MultitaskConfig.from_dict({"locca_enabled": True, "locca_weight": 0.3})
    assert tconfigs.unported_settings(mt) == []
    mt = tconfigs.MultitaskConfig.from_dict({"siglip_sampler": "x"})
    assert tconfigs.unported_settings(mt) == []


# --------------------------------------------------------------------------- #
# the train and eval steps


STEP_CFG = dict(
    frames=4, resize=32, batch_size=3, multi_video=True, num_videos=2,
    vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16], use_cls_token=True,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, decoder_dim=16, decoder_depth=2,
    decoder_heads=2, decoder_max_length=8, mvm_decoder_dim=8, mvm_decoder_depth=1,
    dropout=0.0, lr=1e-3, precision="fp32", consistency_weight=0.5, locca_enabled=True,
    label_smoothing=0.1, scheduler_name="cosine_with_warmup", epochs=2,
)
WEIGHTS = (1.0, 0.7, 0.4)  # contrastive, captioning, mvm


def _step_batch(cfg, B=3, seed=0):
    r = np.random.default_rng(seed)
    vmask = np.ones((B, cfg["num_videos"]), bool)
    vmask[2, 1] = False
    att = np.ones((B, cfg["max_text_length"]), np.int32)
    att[1, 5:] = 0
    cap = np.ones((B, cfg["decoder_max_length"]), np.int32)
    cap[0, 6:] = 0
    return {
        "videos": r.normal(size=(B, cfg["num_videos"], cfg["frames"], cfg["resize"],
                                 cfg["resize"], 3)).astype(np.float32),
        "video_mask": vmask,
        "input_ids": r.integers(0, 256, (B, cfg["max_text_length"])).astype(np.int32),
        "attention_mask": att,
        "caption_ids": r.integers(0, 256, (B, cfg["decoder_max_length"])).astype(np.int32),
        "caption_mask": cap,
        "location_mask": (r.random((B, cfg["decoder_max_length"])) > 0.5).astype(np.float32),
        "caption_weights": np.asarray([1.0, 8.0, 2.0], np.float32),
        "sample_mask": np.ones((B,), np.float32),
    }


class StepPair:
    """The JAX bundle and the port's on the same initial weights, the same
    batch, and the JAX step's MVM mask."""

    def __init__(self, **over):
        d = dict(STEP_CFG, **over)
        self.jcfg = JaxMultitaskConfig.from_dict(dict(d, use_pallas_attention=False))
        self.tcfg = tconfigs.MultitaskConfig.from_dict(dict(d, use_pallas_attention=True))
        mesh = make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
        self.jbundle, self.jstate = jmt.build_multitask_bundle(
            self.jcfg, mesh, jax.random.PRNGKey(0), steps_per_epoch=4)
        self.jbundle = self.jbundle._replace(
            text_model=self.jbundle.text_model.clone(proj_dropout=0.0))
        self.init = jax.tree_util.tree_map(np.array, self.jstate.params)
        self.batch = _step_batch(d)
        self.rng = jax.random.PRNGKey(7)
        n = d["num_videos"] * d["batch_size"]
        L = int(self.init["mvm"]["pos_emb"].shape[1])
        self.mask = np.asarray(jmvm.random_token_mask(jax.random.fold_in(self.rng, 1), n, L,
                                                      self.jcfg.mask_ratio))

    def torch_side(self):
        bundle, state = tmt.build_multitask_bundle(self.tcfg, seed=0, steps_per_epoch=4,
                                                   device="cpu")
        bundle.text_model.proj.dropout = 0.0
        convert.load_multitask_tree(self.init, _models(bundle), state.params["log_temp"])
        batch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        return bundle, state, batch


def _models(bundle):
    return {"video_encoder": bundle.video_model, "text_encoder": bundle.text_model,
            "decoder": bundle.decoder, "mvm": bundle.mvm}


def _grad_tree(bundle, state, grads):
    """Gradients as a JAX-shaped tree (through the parameter names)."""
    params = state.params
    saved = {k: p.detach().clone() for k, p in params.items()}
    with torch.no_grad():
        for k, g in grads.items():
            params[k].copy_(g)
    tree = convert.multitask_tree(_models(bundle), params["log_temp"])
    with torch.no_grad():
        for k, v in saved.items():
            params[k].copy_(v)
    return convert.flatten_tree(tree)


@pytest.fixture(scope="module")
def step_pair():
    return StepPair()


def test_multitask_tree_round_trips(step_pair):
    bundle, state, _ = step_pair.torch_side()
    back = convert.flatten_tree(convert.multitask_tree(_models(bundle),
                                                       state.params["log_temp"]))
    want = convert.flatten_tree(step_pair.init)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # the port's own random init has the JAX tree's names and shapes
    fresh, fstate = tmt.build_multitask_bundle(step_pair.tcfg, device="cpu")
    own = convert.flatten_tree(convert.multitask_tree(_models(fresh),
                                                      fstate.params["log_temp"]))
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in want.items()}


def test_forward_and_gradients_match_jax(step_pair):
    """Every task term and every gradient leaf of the weighted loss, LocCa
    and consistency on, against jax.value_and_grad of the JAX forward:
    losses rtol 1e-4; gradients within 1e-4 of each leaf's largest
    magnitude, and 1e-7 absolute (a key bias does not move the softmax:
    its gradient is rounding noise of order 1e-9); rtol 1e-4 on the
    per-tower norms."""
    p = step_pair
    w_con, w_cap, w_mvm = WEIGHTS
    jb = p.jbundle.batch_sharding_fn(p.batch)

    def loss_fn(params):
        out = jmt.multitask_forward(p.jbundle, params, jb, p.rng, deterministic=False)
        total = (w_con * out["contrastive"] + w_cap * out["captioning"]
                 + w_mvm * out["mvm"] + p.jcfg.consistency_weight * out["consistency"])
        return total, out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p.init))
    bundle, state, batch = p.torch_side()
    tout = tmt.multitask_forward(bundle, state.params["log_temp"], batch, None,
                                 deterministic=False, mvm_mask=torch.from_numpy(p.mask))
    tloss = (w_con * tout["contrastive"] + w_cap * tout["captioning"]
             + w_mvm * tout["mvm"] + p.tcfg.consistency_weight * tout["consistency"])
    for k in ("contrastive", "captioning", "mvm", "consistency", "temperature",
              "locca_captioning", "locca_referring", "locca_grounded"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), err_msg=k, **FP32)
    assert float(tout["consistency"]) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), **FP32)
    np.testing.assert_allclose(tout["caption_logits"].detach().numpy(),
                               np.asarray(jout["caption_logits"]), atol=1e-4, rtol=1e-4)

    names = list(state.params)
    got = torch.autograd.grad(tloss, [state.params[n] for n in names], allow_unused=True)
    tg = _grad_tree(bundle, state, {n: g for n, g in zip(names, got) if g is not None})
    jg = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads))
    assert tg.keys() == jg.keys()
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-6)
        np.testing.assert_allclose(tg[k], jg[k], atol=max(1e-4 * scale, 1e-7), rtol=0,
                                   err_msg=k)
    for tower in ("video_encoder", "text_encoder", "decoder", "mvm"):
        tn = math.sqrt(sum(float((v ** 2).sum()) for k, v in tg.items()
                           if k.startswith(tower + "/")))
        jn = math.sqrt(sum(float((v ** 2).sum()) for k, v in jg.items()
                           if k.startswith(tower + "/")))
        assert tn > 0
        np.testing.assert_allclose(tn, jn, rtol=1e-4, err_msg=tower)


@pytest.mark.parametrize("vfr,tfr,temp", [(0.0, 0.0, -1.0), (0.5, 1.0, 0.2)])
def test_train_step_matches_jax(step_pair, vfr, tfr, temp):
    """One make_multitask_train_step against the JAX step: every metric rtol
    1e-4, every parameter after the update atol 3e-5 (1% of the 3e-3 Adam's
    first step can move it; see tests/test_torch_train.py), the frozen
    leaves and a pinned log_temp exactly where they were."""
    p = step_pair
    jstep = jmt.make_multitask_train_step(p.jbundle)
    _, jstate = jmt.build_multitask_bundle(p.jcfg, p.jbundle.mesh, jax.random.PRNGKey(0),
                                           steps_per_epoch=4)
    jstate, jm = jstep(jstate, p.jbundle.batch_sharding_fn(p.batch), p.rng, *WEIGHTS,
                       vfr, tfr, temp)
    bundle, state, batch = p.torch_side()
    step = tmt.make_multitask_train_step(bundle)
    n_fwd = flash_attention.launches
    state, tm = step(state, batch, None, *WEIGHTS, vfr, tfr, temp,
                     mvm_mask=torch.from_numpy(p.mask))
    assert flash_attention.launches == n_fwd  # CPU tensors never reach a kernel
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **FP32)
    assert state.step == 1 and int(state.opt_state["count"]) == 1
    jf = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    tf = convert.flatten_tree(convert.multitask_tree(_models(bundle),
                                                     state.params["log_temp"]))
    init = convert.flatten_tree(p.init)
    for k in jf:
        a, b = tf[k], jf[k]
        if k.endswith("attn/qkv/bias"):  # the key bias: its gradient is noise
            n = a.shape[0] // 3
            a, b = np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
        np.testing.assert_allclose(a, b, atol=3e-5, rtol=0, err_msg=k)
        assert np.array_equal(tf[k], init[k]) == np.array_equal(jf[k], init[k]), k
    if tfr >= 1.0:
        assert all(np.array_equal(tf[k], init[k]) for k in tf if k.startswith("text_encoder/"))
    if temp > 0:
        assert tf["log_temp"] == init["log_temp"]


def test_gradient_accumulation_matches_jax():
    """MultiSteps(2) against optax.MultiSteps over two micro-steps: nothing
    moves after the first, the same parameters after the second."""
    p = StepPair(gradient_accumulation_steps=2)
    jstep = jmt.make_multitask_train_step(p.jbundle)
    jstate, jb = p.jstate, p.jbundle.batch_sharding_fn(p.batch)
    bundle, state, batch = p.torch_side()
    step = tmt.make_multitask_train_step(bundle)
    mask = torch.from_numpy(p.mask)
    for i in range(2):
        jstate, jm = jstep(jstate, jb, p.rng, *WEIGHTS, 0.0, 0.0, -1.0)
        state, tm = step(state, batch, None, *WEIGHTS, 0.0, 0.0, -1.0, mvm_mask=mask)
        for k in ("loss", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **FP32)
    assert int(state.opt_state["gradient_step"]) == 1
    jf = convert.flatten_tree(jax.tree_util.tree_map(np.asarray, jstate.params))
    tf = convert.flatten_tree(convert.multitask_tree(_models(bundle),
                                                     state.params["log_temp"]))
    for k in jf:
        if not k.endswith("attn/qkv/bias"):
            np.testing.assert_allclose(tf[k], jf[k], atol=3e-5, rtol=0, err_msg=k)


def test_eval_step_matches_jax(step_pair):
    """The deterministic forward: losses rtol 1e-4, the video tokens the
    validation pass decodes from atol 1e-5. The port's eval step draws its
    MVM mask from a generator seeded 0 at each call: two calls agree."""
    p = step_pair
    jout = jax.jit(lambda params, batch: jmt.multitask_forward(
        p.jbundle, params, batch, jax.random.PRNGKey(0), deterministic=True))(
        jax.tree_util.tree_map(jnp.asarray, p.init), p.jbundle.batch_sharding_fn(p.batch))
    bundle, state, batch = p.torch_side()
    eval_step = tmt.make_multitask_eval_step(bundle)
    a, b = eval_step(state.params, batch), eval_step(state.params, batch)
    for k in ("contrastive", "captioning", "consistency"):
        np.testing.assert_allclose(float(a[k]), float(jout[k]), err_msg=k, **FP32)
    assert torch.equal(a["mvm"], b["mvm"]) and math.isfinite(float(a["mvm"]))
    np.testing.assert_allclose(a["video_tokens"].numpy(), np.asarray(jout["video_tokens"]),
                               atol=1e-5, rtol=1e-5)


def test_nonfinite_loss_changes_nothing(step_pair):
    bundle, state, batch = step_pair.torch_side()
    step = tmt.make_multitask_train_step(bundle)
    state, _ = step(state, batch, None)
    snap = {k: v.detach().clone() for k, v in state.params.items()}
    with torch.no_grad():
        good = state.params["log_temp"].clone()
        state.params["log_temp"].fill_(float("nan"))
    state, m = step(state, batch, None)
    assert not math.isfinite(float(m["loss"])) and int(state.opt_state["count"]) == 1
    with torch.no_grad():
        state.params["log_temp"].copy_(good)
    for k in snap:
        assert torch.equal(state.params[k], snap[k]), k


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmt.build_multitask_bundle(tconfigs.MultitaskConfig.from_dict(STEP_CFG))


# --------------------------------------------------------------------------- #
# the runner against the JAX runner, and resume


RUNNER_CFG = dict(
    pipeline_project="DeepCORO_multitask", run_mode="train",
    epochs=2, batch_size=2, frames=4, resize=32, num_workers=1,
    vit_dim=32, vit_depth=1, vit_heads=1, vit_patch=[2, 16, 16],
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=512,
    max_text_length=16, embedding_dim=16, num_heads=2, aggregator_depth=1,
    decoder_dim=16, decoder_depth=1, decoder_heads=2, decoder_max_length=12,
    mvm_decoder_dim=8, mvm_decoder_depth=1, mask_ratio=0.5, locca_enabled=True,
    loss_weights={"contrastive": 1.0, "captioning": 0.5, "mvm": 0.0},
    dropout=0.0, lr=1e-3, precision="fp32", use_pallas_attention=False,
    use_wandb=False, seed=0,
)
# the MVM term is left out: its mask is drawn differently (see the top)
EPOCH_KEYS = ("loss", "loss_contrastive", "loss_captioning", "loss_consistency",
              "temperature", "lr", "val_loss", "val_bleu1", "val_bleu2", "val_bleu3",
              "val_bleu4", "val_rouge_l", "val_meteor")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The workspace of tests/runners/test_multitask.py: 8 clips of
    6 x 32 x 32 (6 train, 2 val) behind an ``α``-separated manifest."""
    root = tmp_path_factory.mktemp("mt")
    r = np.random.default_rng(0)
    rows = []
    for i in range(8):
        p = root / f"c{i}.npy"
        np.save(p, r.integers(0, 255, size=(6, 32, 32, 3)).astype(np.uint8))
        rows.append({
            "FileName": str(p), "StudyInstanceUID": f"S{i}",
            "Split": "train" if i < 6 else "val",
            "Report": f"severe stenosis of the proximal lad {i}" if i % 2
            else f"normal coronary arteries {i}",
        })
    write_csv(root / "d.csv", ["FileName", "StudyInstanceUID", "Split", "Report"], rows)
    return root


def _write_yaml(root: Path, name: str, **over) -> Path:
    cfg = dict(RUNNER_CFG, data_filename=str(root / "d.csv"),
               output_dir=str(root / name), **over)
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def runs(workspace):
    """(JAX history, port history, port runner) over the same 2 epochs."""
    path = _write_yaml(workspace, "parity")
    mesh = make_mesh(MeshSpec(data=1, model=1), devices=jax.devices()[:1])
    jr = JaxRunner(jax_parse_config(["--base_config", str(path)]),
                   output_dir=workspace / "jax_run", mesh=mesh)
    jr.bundle = jr.bundle._replace(text_model=jr.bundle.text_model.clone(proj_dropout=0.0))
    jr.train_step = jmt.make_multitask_train_step(jr.bundle)
    jr._val_fwd = jax.jit(lambda params, batch, rng: jmt.multitask_forward(
        jr.bundle, params, batch, rng, deterministic=True))
    init = jax.tree_util.tree_map(np.array, jr.state.params)
    jhist = jr.train()["history"]

    cfg = tconfigs.parse_config(["--base_config", str(path), "--device", "cpu"])
    tr = trun.MultitaskRunner(cfg, output_dir=workspace / "port_run")
    tr.bundle.text_model.proj.dropout = 0.0
    convert.load_multitask_tree(init, _models(tr.bundle), tr.state.params["log_temp"])
    thist = tr.train()["history"]
    return jhist, thist, tr


def test_runner_matches_jax_per_epoch(runs):
    """Two epochs: the losses (but MVM's), temperature, rate, validation
    loss within rtol 1e-4 of the JAX runner's; the greedy captions' BLEU,
    ROUGE-L and METEOR equal to it (the same token ids)."""
    jhist, thist, _ = runs
    assert len(jhist) == len(thist) == 2
    for j, t in zip(jhist, thist):
        for key in EPOCH_KEYS:
            assert key in j and key in t, key
            if key.startswith(("val_bleu", "val_rouge", "val_meteor")):
                assert t[key] == j[key], (t["epoch"], key)
            else:
                np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-7,
                                           err_msg=f"epoch {t['epoch']} {key}")


def test_history_checkpoints_and_captions(runs, workspace):
    """The JAX runner's history keys plus the loader's wait and the two
    timings; the latest and best checkpoints with their sidecars; the
    captions CSV of each epoch, one row per validation study."""
    import csv

    jhist, thist, tr = runs
    for j, t in zip(jhist, thist):
        assert set(t) - set(j) == {"loader_wait_ms", "epoch_seconds", "val_seconds"}
        assert set(j) <= set(t)
    ck = workspace / "port_run" / "checkpoints"
    names = sorted(p.name for p in ck.iterdir())
    assert "checkpoint.pt" in names and "checkpoint.json" in names
    best = [n for n in names if n.startswith("best_model_epoch_")]
    assert sorted(Path(n).suffix for n in best) == [".json", ".pt"]
    saved = torch.load(ck / "checkpoint.pt", weights_only=True)
    assert saved["step"] == 6 and saved["meta"]["global_step"] == 6
    assert {"decoder.lm_head.weight", "mvm.mask_token", "log_temp"} <= set(saved["params"])
    for epoch in (0, 1):
        rows = list(csv.reader(open(workspace / "port_run" / "val" /
                                    f"captions_epoch_{epoch}.csv")))
        assert rows[0] == ["generated", "reference"] and len(rows) == 3


def test_resume_repeats_the_uninterrupted_run(workspace, monkeypatch):
    """Through ``main`` on the CPU, dropout 0.1 and the MVM term on: a run
    stopped after epoch 0 and resumed with ``resume_training`` +
    ``checkpoint`` ends bit-equal to an uninterrupted 2-epoch run."""
    path = _write_yaml(workspace, "resume", dropout=0.1,
                       loss_weights={"contrastive": 1.0, "captioning": 0.5, "mvm": 0.5})
    argv = ["--base_config", str(path), "--device", "cpu"]
    full = main(argv)
    train = trun.MultitaskRunner.train
    monkeypatch.setattr(trun.MultitaskRunner, "train",
                        lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
    cut = main(argv)
    monkeypatch.undo()
    assert [h["epoch"] for h in cut["history"]] == [0]
    resumed = main(argv + ["--resume_training", "true", "--checkpoint", cut["output_dir"]])
    assert resumed["output_dir"] == cut["output_dir"]
    assert [h["epoch"] for h in resumed["history"]] == [1]
    for key in ("loss", "loss_mvm", "val_loss", "val_bleu1"):
        assert resumed["history"][0][key] == full["history"][1][key], key
    a = torch.load(Path(full["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    b = torch.load(Path(cut["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_nonfinite_loss_saves_a_snapshot_and_raises(workspace):
    """A NaN loss: the ``nan_debug`` snapshot, no resumable checkpoint, and
    ``NonFiniteLossError``, as in the contrastive runner."""
    cfg = tconfigs.parse_config(["--base_config", str(_write_yaml(workspace, "nan")),
                                 "--device", "cpu"])
    r = trun.MultitaskRunner(cfg, output_dir=workspace / "nan_run")
    with torch.no_grad():
        r.state.params["log_temp"].fill_(float("nan"))
    with pytest.raises(trun.NonFiniteLossError, match="non-finite loss"):
        r.train()
    meta = r.ckpt.load_meta("nan_debug")
    assert meta["nan_loss_at_step"] == 0 and not r.ckpt.latest_exists()


def test_early_stopping(workspace):
    """lr 0: the validation loss never improves after epoch 0, so patience 2
    stops the run after epoch 2 of 6 (the JAX runner's rule)."""
    cfg = tconfigs.parse_config(["--base_config", str(_write_yaml(
        workspace, "early", epochs=6, lr=0.0, early_stopping_patience=2)), "--device", "cpu"])
    result = trun.MultitaskRunner(cfg, output_dir=workspace / "early_run").train()
    assert [h["epoch"] for h in result["history"]] == [0, 1, 2]
    assert result["best_epoch"] == 0


def test_main_needs_the_card_unless_asked_for_the_cpu(workspace):
    """Through ``main`` with the shipped YAML: without CUDA and without
    ``--device cpu`` the run raises before it reads any data."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--base_config", str(REPO / "config/multitask/multitask_config.yaml"),
              "--data_filename", str(workspace / "d.csv"),
              "--output_dir", str(workspace / "no_card")])
