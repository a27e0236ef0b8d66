"""Tensor parallelism of the port in training: the train steps of every
pipeline on a ``(data, model)`` grid of ``gloo`` ranks against the JAX
step on ``MeshSpec`` of the same shape (its parameters placed by their
partition specs), and runs through ``main`` at ``mesh_model`` 2 without the
ring against the one-process runs, with their checkpoints both ways.

The ranks are ``torch.multiprocessing`` children
(``tests/test_torch_tp_workers.py``, which imports the port only, through
``tests/test_torch_ddp_workers.start``): a 2-rank launch (the grid
``(1, 2)``) and a 4-rank one (``(2, 2)``), started together by one
module-scoped fixture while the JAX steps and the one-process runs go on
here.

- One step each of CLIP, SigLIP multi-positive (the bank replicated),
  multitask (LocCa and consistency on, the JAX step's MVM mask handed over)
  and probing (encoder trained) at ``(1, 2)``, and CLIP at ``(2, 2)`` on a
  3-row batch padded to 4, against the JAX step on ``MeshSpec(data,
  model=2)``: every tower at 2 heads, so that each rank holds one head of
  every attention and half of every MLP. The loss (rtol 1e-4), every
  gradient leaf (within 1e-4 of the leaf's largest magnitude, 1e-7
  absolute), every metric (rtol 1e-4) and the parameters after the update
  (atol 3e-5 where the gradient is resolved, the key bias's middle third
  left out): the bars of ``tests/test_torch_distributed.py``. Loss,
  gradients, metrics and parameters are bit-equal across the ranks.
- ``main`` at ``mesh_model`` 2 (``config/quality/flagship_quality_train.yaml``
  at tiny widths, fp32, dropout 0.1, 2 epochs) against the same run at
  world 1: each epoch's loss and validation loss within rtol 1e-4; every
  rank the same history; rank 0 alone writes; the checkpoint holds the
  whole tree (the one-process checkpoint's names and shapes, moments too).
  A run cut after epoch 0 and resumed at ``mesh_model`` 2 ends with the
  uninterrupted run's parameters, bit for bit; the one-process run's
  epoch-0 checkpoint resumed at ``mesh_model`` 2, and the ``mesh_model``-2
  epoch-0 checkpoint resumed at world 1, each end epoch 1 within rtol 1e-4
  of the uninterrupted runs' loss. A warm start (``init_from_checkpoint``)
  from the world-1 run's ``.pt`` at ``mesh_model`` 2: its epoch within rtol
  1e-4 of the same warm start at world 1.
- ``main`` at ``mesh_model`` 2 on ``siglip_multi_positive_config.yaml``,
  ``multitask_config.yaml`` and ``stenosis_config.yaml`` at tiny widths, one
  epoch each: the train and validation losses within rtol 1e-4 of the
  one-process runs'. The SigLIP sampler draws its negatives in the order
  Python's string hashing gives a set, so the children share one
  ``PYTHONHASHSEED`` and the world-1 SigLIP run is a child of its own; the
  ranks of a model group share its first rank's batch whatever their
  seeds (``distributed.share_over_model``).
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs import MultitaskConfig as JaxMultitaskConfig
from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig
from deepcoro_clip_tpu.configs.linear_probing import LinearProbingConfig as JaxProbeConfig
from deepcoro_clip_tpu.losses.heads import multi_head_loss as jax_multi_head_loss
from deepcoro_clip_tpu.models import masked_video_modeling as jmvm
from deepcoro_clip_tpu.parallel import MeshSpec as JMeshSpec
from deepcoro_clip_tpu.parallel import make_mesh as jmake_mesh
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.train import clip as jclip
from deepcoro_clip_tpu.train import linear_probe as jprobe
from deepcoro_clip_tpu.train import multitask as jmt

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.parallel.mesh import pad_to_multiple
from deepcoro_clip_tpu_torch.runners import contrastive as trun
from deepcoro_clip_tpu_torch.runners import multitask as mrun

from tests import test_torch_ddp_workers as workers
from tests import test_torch_tp_workers as tp_workers
from tests.single_head_runs import siglip_corpus

register_all()

FP32 = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 3e-5
RUN_RTOL = 1e-4
NOISE_LEAF = "_gated/w/bias"  # the probing head's gate bias: a noise gradient
REPO = Path(__file__).resolve().parents[1]
QUALITY_YAML = REPO / "config/quality/flagship_quality_train.yaml"
SIGLIP_YAML = REPO / "config/clip/siglip_multi_positive_config.yaml"

# every tower at 2 heads: each rank of the model group holds one
CLIP = dict(
    frames=4, resize=32, batch_size=3, multi_video=False, num_videos=1,
    vit_dim=32, vit_depth=1, vit_heads=2, vit_patch=[2, 16, 16], use_cls_token=True,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, dropout=0.0, lr=1e-3,
    precision="fp32", scheduler_name="cosine", epochs=2, temperature=0.1,
    siglip_max_positive_per_video=2, siglip_negatives_per_video=2,
    siglip_entropy_reg_weight=0.3, siglip_positive_loss_weight=1.3,
    siglip_negative_loss_weight=0.8, siglip_bias_init=-2.0, mesh_model=2,
)
MULTITASK = dict(
    frames=4, resize=32, batch_size=3, multi_video=True, num_videos=2,
    vit_dim=32, vit_depth=1, vit_heads=2, vit_patch=[2, 16, 16], use_cls_token=True,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, decoder_dim=16, decoder_depth=2,
    decoder_heads=2, decoder_max_length=8, mvm_decoder_dim=8, mvm_decoder_depth=1,
    dropout=0.0, lr=1e-3, precision="fp32", consistency_weight=0.5, locca_enabled=True,
    label_smoothing=0.1, scheduler_name="cosine", epochs=2, mesh_model=2,
)
PROBE = dict(
    frames=4, resize=32, batch_size=3, num_videos=3, vit_dim=32, vit_depth=1,
    vit_heads=2, vit_patch=[2, 16, 16], embedding_dim=32, num_heads=2,
    attention_hidden=8, dropout=0.0, dropout_attention=0.0, precision="fp32",
    use_pallas_attention=True, epochs=2, scheduler_name="cosine",
    pooling_mode="attention+cls_token", use_cls_token=True,
    normalization_strategy="pre_norm", lr=0.001, mesh_model=2,
    head_structure={"stenosis": 1, "stenosis_binary": 1, "CTO": 1},
    loss_structure={"stenosis": "huber", "stenosis_binary": "bce_logit", "CTO": "bce_logit"},
    head_weights={"stenosis": 2.0},
)
WEIGHTS = (1.0, 0.7, 0.4)  # contrastive, captioning, mvm
MT_RNG = jax.random.PRNGKey(7)
GRID_1_2, GRID_2_2 = (1, 2), (2, 2)
# the runs through main on the (1, 2) launch, by their index in its jobs
MAIN_JOBS = {"quality": 0, "cut": 1, "resumed": 2, "from_one": 3, "siglip": 4,
             "multitask": 5, "probing": 6, "cut_for_one": 7, "warm": 8}
STEP_CASES = {"clip": GRID_1_2, "siglip_multi_positive": GRID_1_2,
              "multitask": GRID_1_2, "probe": GRID_1_2, "clip_data2": GRID_2_2}


def _mesh(grid):
    data, model = grid
    return jmake_mesh(JMeshSpec(data=data, model=model), devices=jax.devices()[:data * model])


def _videos(r, B, N, cfg):
    return r.normal(size=(B, N, cfg["frames"], cfg["resize"], cfg["resize"], 3)
                    ).astype(np.float32)


def _clip_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, L = 3, cfg["max_text_length"]
    att = np.ones((B, L), np.int32)
    att[1, 5:] = 0
    return {"videos": _videos(r, B, 1, cfg), "video_mask": np.ones((B, 1), bool),
            "input_ids": r.integers(0, 256, (B, L)).astype(np.int32),
            "attention_mask": att}


def _bank_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, L = 3, cfg["max_text_length"]
    M = B * (cfg["siglip_max_positive_per_video"] + cfg["siglip_negatives_per_video"])
    att = np.ones((M, L), np.int32)
    att[1, 5:] = 0
    att[-3:, 2:] = 0
    pos = np.zeros((B, M), np.float32)
    pos[0, [0, 1]] = pos[1, 2] = pos[2, [3, 4]] = 1.0
    return {"videos": _videos(r, B, 1, cfg), "video_mask": np.ones((B, 1), bool),
            "input_ids": r.integers(0, 256, (M, L)).astype(np.int32),
            "attention_mask": att, "positive_mask": pos,
            "text_valid": np.r_[np.ones(M - 3), np.zeros(3)].astype(np.float32),
            "positive_weights": r.uniform(0.75, 2.5, (B, M)).astype(np.float32)}


def _multitask_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, N, L, C = 3, cfg["num_videos"], cfg["max_text_length"], cfg["decoder_max_length"]
    vmask = np.ones((B, N), bool)
    vmask[2, 1] = False
    att = np.ones((B, L), np.int32)
    att[1, 5:] = 0
    cap = np.ones((B, C), np.int32)
    cap[0, 6:] = 0
    return {"videos": _videos(r, B, N, cfg), "video_mask": vmask,
            "input_ids": r.integers(0, 256, (B, L)).astype(np.int32),
            "attention_mask": att,
            "caption_ids": r.integers(0, 256, (B, C)).astype(np.int32),
            "caption_mask": cap,
            "location_mask": (r.random((B, C)) > 0.5).astype(np.float32),
            "caption_weights": np.asarray([1.0, 8.0, 2.0], np.float32)}


def _probe_batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    B, N = 3, cfg["num_videos"]
    mask = np.ones((B, N), bool)
    mask[1, 1:] = False
    return {"videos": _videos(r, B, N, cfg), "video_mask": mask,
            "targets": {"stenosis": r.random(B).astype(np.float32),
                        **{h: (r.random(B) > 0.5).astype(np.float32)
                           for h in ("stenosis_binary", "CTO")}}}


def _flat(tree):
    return convert.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_clip(cfg_dict, batch, grid):
    jcfg = JaxClipConfig.from_dict(dict(cfg_dict, use_pallas_attention=False))
    bundle, state = jclip.build_clip_bundle(jcfg, _mesh(grid), jax.random.PRNGKey(0),
                                            steps_per_epoch=4)
    bundle = bundle._replace(text_model=bundle.text_model.clone(proj_dropout=0.0))
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)

    def loss_fn(params):
        out = jclip.compute_loss(bundle, params, jb, {"dropout": jax.random.PRNGKey(1)},
                                 deterministic=False)
        return out["loss"], out

    def compute():
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jclip.make_train_step(bundle)(state, jb,
                                                       jax.random.PRNGKey(1), 0.0, 0.0, -1.0)
        return {"loss": float(loss), "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, compute


def _jax_multitask(cfg_dict, batch, grid):
    jcfg = JaxMultitaskConfig.from_dict(dict(cfg_dict, use_pallas_attention=False))
    bundle, state = jmt.build_multitask_bundle(jcfg, _mesh(grid), jax.random.PRNGKey(0),
                                               steps_per_epoch=4)
    bundle = bundle._replace(text_model=bundle.text_model.clone(proj_dropout=0.0))
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)
    w_con, w_cap, w_mvm = WEIGHTS

    def loss_fn(params):
        out = jmt.multitask_forward(bundle, params, jb, MT_RNG, deterministic=False)
        return (w_con * out["contrastive"] + w_cap * out["captioning"] + w_mvm * out["mvm"]
                + jcfg.consistency_weight * out["consistency"]), out

    rows = pad_to_multiple(len(batch["videos"]), grid[0]) * cfg_dict["num_videos"]
    mask = np.asarray(jmvm.random_token_mask(
        jax.random.fold_in(MT_RNG, 1), rows, int(init["mvm"]["pos_emb"].shape[1]),
        jcfg.mask_ratio))

    def compute():
        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jmt.make_multitask_train_step(bundle)(
            state, jb, MT_RNG, *WEIGHTS, 0.0, 0.0, -1.0)
        terms = {k: float(out[k]) for k in ("contrastive", "captioning", "mvm",
                                            "consistency")}
        return {"loss": float(loss), "terms": terms, "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, mask, compute


def _jax_probe(cfg_dict, batch, grid, ratio):
    jcfg = JaxProbeConfig.from_dict(cfg_dict)
    bundle, state = jprobe.build_probe_bundle(jcfg, _mesh(grid), jax.random.PRNGKey(0),
                                              steps_per_epoch=4)
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)

    def loss_fn(params):
        outputs, _ = jprobe.forward_heads(bundle, params, jb,
                                          {"dropout": jax.random.PRNGKey(0)},
                                          deterministic=False)
        losses = jax_multi_head_loss(outputs, jb["targets"], dict(jcfg.loss_structure),
                                     head_weights=dict(jcfg.head_weights),
                                     sample_mask=jb.get("sample_mask"))
        return losses["main"]

    def compute():
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jprobe.make_probe_train_step(bundle)(state, jb,
                                                              jax.random.PRNGKey(0), ratio)
        return {"loss": float(loss), "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, compute


def _step_specs():
    """({name: the ranks' case}, {name: the JAX step's compute})."""
    spec, compute = {}, {}
    for name, loss, grid in (("clip", "clip", GRID_1_2),
                             ("clip_data2", "clip", GRID_2_2),
                             ("siglip_multi_positive", "siglip_pairwise", GRID_1_2)):
        cfg = dict(CLIP, loss_name=loss, mesh_data=grid[0])
        if loss == "clip":
            cfg["label_smoothing"] = 0.1
        batch = (_clip_batch if loss == "clip" else _bank_batch)(cfg)
        init, compute[name] = _jax_clip(cfg, batch, grid)
        spec[name] = {"kind": "clip", "config": dict(cfg, use_pallas_attention=True),
                      "init": init, "batch": batch}
    batch = _multitask_batch(MULTITASK)
    init, mask, compute["multitask"] = _jax_multitask(MULTITASK, batch, GRID_1_2)
    spec["multitask"] = {"kind": "multitask", "config": dict(MULTITASK,
                                                             use_pallas_attention=True),
                         "init": init, "batch": batch, "mvm_mask": mask, "weights": WEIGHTS}
    batch = _probe_batch(PROBE)
    init, compute["probe"] = _jax_probe(PROBE, batch, GRID_1_2, 0.0)
    spec["probe"] = {"kind": "probe", "config": PROBE, "init": init, "batch": batch,
                     "ratio": 0.0}
    return spec, compute


# --------------------------------------------------------------------------- #
# the runs through main


HEADS = ("stenosis", "stenosis_binary", "calcif_binary", "CTO")
TINY = dict(frames=4, resize=32, vit_dim=32, vit_depth=1, vit_heads=2, vit_pool_stages=[],
            text_dim=32, text_depth=1, text_heads=2, max_text_length=16, embedding_dim=16,
            num_heads=2, aggregator_depth=1, precision="fp32", use_pallas_attention=False,
            num_workers=1, device="cpu")


def _workspace(root: Path) -> None:
    r = np.random.default_rng(0)
    rows = []
    for i in range(12):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(8, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p), "Report": f"left main stenosis {i % 3} report",
                     "StudyInstanceUID": f"S{i // 2 if i < 8 else i}",
                     "Split": "train" if i < 8 else "val",
                     "stenosis": f"{r.random():.3f}", "stenosis_binary": str(i % 2),
                     "calcif_binary": str((i // 2) % 2), "CTO": str(int(i % 3 == 0))})
    write_csv(root / "data.csv", ["FileName", "Report", "StudyInstanceUID", "Split", *HEADS],
              rows)


def _yaml(root: Path, base: Path, name: str, model: int, **over) -> str:
    cfg = yaml.safe_load(base.read_text())
    cfg.update(TINY, output_dir=str(root / "runs" / name), mesh_model=model, mesh_data=-1)
    cfg.update(over)
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _mains(root: Path, corpus: dict) -> dict:
    """{name: (argv at mesh_model 2, argv at world 1)} of the runs through
    main; ``quality2_cut`` and ``quality2_cut_for_one``: the quality run at
    mesh_model 2 in directories of their own, to be cut (and resumed at
    mesh_model 2, and at world 1)."""
    quality = dict(data_filename=str(root / "data.csv"), epochs=2, batch_size=4, dropout=0.1)
    paths = corpus["paths"]
    siglip = dict(data_filename=str(paths["videos"]), siglip_texts_path=str(paths["texts"]),
                  siglip_edges_path=str(paths["edges"]), epochs=1, batch_size=4,
                  siglip_max_positive_per_video=2, siglip_negatives_per_video=6, dropout=0.0,
                  lr=1e-3, recall_k=[1, 5], ndcg_k=[5], video_freeze_ratio=0.0,
                  text_freeze_ratio=0.0, num_videos=1, multi_video=False)
    out = {}
    for name, base, over in (("quality", QUALITY_YAML, quality),
                             ("siglip", SIGLIP_YAML, siglip)):
        out[name] = tuple(["--base_config", _yaml(root, base, f"{name}{m}", m, **over)]
                          for m in (2, 1))
    for name in ("quality2_cut", "quality2_cut_for_one"):
        out[name] = ["--base_config", _yaml(root, QUALITY_YAML, name, 2, **quality)]
    mt = ["--base_config", "config/multitask/multitask_config.yaml", "--device", "cpu",
          "--data_filename", str(root / "data.csv"), "--batch_size", "2", "--num_videos", "2",
          "--dropout", "0", "--decoder_dim", "16", "--decoder_depth", "1", "--decoder_heads",
          "2", "--decoder_max_length", "16", "--mvm_decoder_dim", "8", "--mvm_decoder_depth",
          "1", "--loss_weights", "{contrastive: 1.0, captioning: 1.0, mvm: 0.0}",
          "--epochs", "1"]
    probe = ["--base_config", "config/linear_probing/stenosis_config.yaml", "--device", "cpu",
             "--data_filename", str(root / "data.csv"), "--batch_size", "2", "--num_videos",
             "2", "--dropout", "0", "--dropout_attention", "0", "--attention_hidden", "8",
             "--epochs", "1"]
    tiny = ["--vit_pool_stages", "[]"]
    for k in ("frames", "resize", "vit_dim", "vit_depth", "vit_heads", "embedding_dim",
              "num_heads", "precision", "num_workers"):
        tiny += [f"--{k}", str(TINY[k])]
    text = ["--text_dim", "32", "--text_depth", "1", "--text_heads", "2",
            "--max_text_length", "16", "--aggregator_depth", "1"]
    for name, argv in (("multitask", mt + tiny + text), ("probing", probe + tiny)):
        out[name] = tuple(argv + ["--mesh_model", str(m), "--output_dir",
                                  str(root / "runs" / f"{name}{m}")] for m in (2, 1))
    return out


def _port_main(mp, argv, cut=False):
    """The port's ``main`` here (world 1), the text head's projection
    dropout off as on the ranks; ``cut`` stops it after epoch 0."""
    runner = trun.VideoContrastiveLearningRunner
    train = runner.train
    inits = {cls: cls.__init__ for cls in (runner, mrun.MultitaskRunner)}

    def without_dropout(init):
        def wrapped(self, *a, **kw):
            init(self, *a, **kw)
            self.bundle.text_model.proj.dropout = 0.0
        return wrapped

    for cls, init in inits.items():
        mp.setattr(cls, "__init__", without_dropout(init))
    if cut:
        mp.setattr(runner, "train",
                   lambda self, start_epoch=0, end_epoch=None: train(self, start_epoch, 1))
    try:
        out = main(argv)
    finally:
        for cls, init in inits.items():
            mp.setattr(cls, "__init__", init)
        mp.setattr(runner, "train", train)
    return {k: out.get(k) for k in ("history", "output_dir")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX step results, the (1, 2) launch's results, the (2, 2) launch's
    results, the one-process runs, the workspace)."""
    root = tmp_path_factory.mktemp("tp_steps")
    mp = pytest.MonkeyPatch()
    _workspace(root)
    corpus = siglip_corpus(root / "siglip", seed=3, n_train=8, n_val=4)
    mains = _mains(root, corpus)
    one = {"quality_cut": _port_main(mp, mains["quality"][1], cut=True)}

    def warm(name):  # a warm start from the world-1 run's epoch-0 checkpoint file
        pt = Path(one["quality_cut"]["output_dir"]) / "checkpoints" / "checkpoint.pt"
        return ["--output_dir", str(root / "runs" / name), "--init_from_checkpoint", str(pt),
                "--epochs", "1"]

    spec, compute = _step_specs()
    two_steps = {k: v for k, v in spec.items() if STEP_CASES[k] == GRID_1_2}
    # (job indices: MAIN_JOBS)
    jobs = [{"argv": mains["quality"][0]},
            {"argv": mains["quality2_cut"], "cut": True},
            {"argv": mains["quality2_cut"], "resume_from": 1},
            {"argv": mains["quality"][0] + ["--output_dir", str(root / "runs" / "from_one"),
                                            "--resume_training", "true", "--checkpoint",
                                            one["quality_cut"]["output_dir"]]},
            {"argv": mains["siglip"][0]}, {"argv": mains["multitask"][0]},
            {"argv": mains["probing"][0]},
            {"argv": mains["quality2_cut_for_one"], "cut": True},
            {"argv": mains["quality"][0] + warm("warm2")}]
    # the SigLIP run at world 1 in a child too: its sampler orders sets of
    # strings by Python's hashing, which every child seeds alike here
    parts = {2: {"steps": two_steps, "mains": jobs, "audit_root": str(root / "runs")},
             4: {"steps": {"clip_data2": spec["clip_data2"]}},
             1: {"mains": [{"argv": mains["siglip"][1]}],
                 "audit_root": str(root / "runs_one")}}
    mp.setenv("PYTHONHASHSEED", "0")
    waits = {}
    for world, part in parts.items():
        out = root / f"world{world}"
        out.mkdir()
        job = {k: v for k, v in part.items() if k != "steps"}
        if "steps" in part:
            (out / "steps.pkl").write_bytes(pickle.dumps(part["steps"]))
            job["steps"] = str(out / "steps.pkl")
        (out / "job.pkl").write_bytes(pickle.dumps(job))
        waits[world] = workers.start(tp_workers.job, world, out, str(out / "job.pkl"))
    mp.delenv("PYTHONHASHSEED")
    want = {name: fn() for name, fn in compute.items()}
    for name in ("quality", "multitask", "probing"):
        one[name] = _port_main(mp, mains[name][1])
    one["warm"] = _port_main(mp, mains["quality"][1] + warm("warm1"))
    two, four = waits[2](), waits[4]()
    one["siglip"] = waits[1]()[0]["mains"][0]
    # the mesh_model-2 run's epoch-0 checkpoint resumed here, at world 1
    cut2 = two[0]["mains"][MAIN_JOBS["cut_for_one"]]["output_dir"]
    one["from_two"] = _port_main(mp, mains["quality"][1][:2] + [
        "--output_dir", str(root / "runs" / "from_two"), "--resume_training", "true",
        "--checkpoint", cut2])
    mp.undo()
    return want, two, four, one, root


# --------------------------------------------------------------------------- #
# the steps against the JAX step


def _step_results(runs, case):
    _, two, four, _, _ = runs
    return [r["steps"][case] for r in (four if STEP_CASES[case] == GRID_2_2 else two)]


def _without_key_bias(k, a, b):
    if k.endswith("attn/qkv/bias"):
        n = a.shape[0] // 3
        return np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
    return a, b


@pytest.mark.parametrize("case", STEP_CASES)
def test_step_runs_on_the_grid(runs, case):
    data, model = STEP_CASES[case]
    ranks = _step_results(runs, case)
    assert [r["index"] for r in ranks] == [{"data": i // model, "model": i % model}
                                          for i in range(data * model)]
    assert all(r["grid"] == {"data": data, "model": model} for r in ranks)


@pytest.mark.parametrize("case", STEP_CASES)
def test_loss_and_gradients_match_jax(runs, case):
    j = runs[0][case]
    for got in _step_results(runs, case):
        np.testing.assert_allclose(got["loss"], j["loss"], **FP32)
        if "terms" in j:
            for k, v in j["terms"].items():
                np.testing.assert_allclose(got["terms"][k], v, err_msg=k, **FP32)
        assert got["grads"].keys() == j["grads"].keys()
        for k, g in j["grads"].items():
            scale = max(float(np.abs(g).max()), 1e-6)
            np.testing.assert_allclose(got["grads"][k], g, atol=max(1e-4 * scale, 1e-7),
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_step_matches_jax(runs, case):
    """Every metric rtol 1e-4; the parameters after the update atol 3e-5
    where the JAX gradient is resolved (``tests/test_torch_distributed.py``)."""
    j = runs[0][case]
    for got in _step_results(runs, case):
        assert set(got["metrics"]) == set(j["metrics"])
        for k, v in j["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **FP32)
        assert got["params"].keys() == j["params"].keys()
        for k, v in j["params"].items():
            if k.endswith(NOISE_LEAF):
                continue
            g = j["grads"][k]
            resolved = np.abs(g) > 1e-4 * max(float(np.abs(g).max()), 1e-6)
            a, b = _without_key_bias(k, np.where(resolved, got["params"][k], v), v)
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", STEP_CASES)
def test_ranks_agree_bit_for_bit(runs, case):
    first, *rest = _step_results(runs, case)
    for other in rest:
        assert other["loss"] == first["loss"] and other["metrics"] == first["metrics"]
        for key in ("grads", "params"):
            for k in first[key]:
                np.testing.assert_array_equal(other[key][k], first[key][k], err_msg=k)


# --------------------------------------------------------------------------- #
# the runs through main


def _untimed(h):
    """An epoch's entry without its host times (each rank reads its own
    clock)."""
    return {k: v for k, v in h.items() if not k.endswith(("_seconds", "_ms"))}


def _mains_of(runs):
    _, two, _, _, _ = runs
    return [r["mains"] for r in two]


@pytest.mark.parametrize("name", ["quality", "siglip", "multitask", "probing"])
def test_main_at_model_2_matches_one_process(runs, name):
    ranks = [m[MAIN_JOBS[name]] for m in _mains_of(runs)]
    first = [_untimed(h) for h in ranks[0]["history"]]
    for r in ranks[1:]:
        other = [_untimed(h) for h in r["history"]]
        assert other == first, [(k, a[k], b.get(k)) for a, b in zip(first, other)
                                for k in a if a[k] != b.get(k)]
    want = runs[3][name]["history"]
    assert len(first) == len(want)
    for h, w in zip(first, want):
        for k in ("loss", "val_loss"):
            if k in w:
                assert np.isfinite(h[k])
                np.testing.assert_allclose(h[k], w[k], rtol=RUN_RTOL, err_msg=f"{name} {k}")


def test_main_at_model_2_resumes_bit_equal(runs):
    full, resumed = (_mains_of(runs)[0][MAIN_JOBS[k]] for k in ("quality", "resumed"))
    assert [h["epoch"] for h in resumed["history"]] == [1]
    assert resumed["history"][0]["loss"] == full["history"][1]["loss"]
    a = torch.load(Path(full["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    b = torch.load(Path(resumed["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == 4
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k in a["opt_state"]["mu"]:
        assert torch.equal(a["opt_state"]["mu"][k], b["opt_state"]["mu"][k]), k


def test_checkpoint_holds_the_whole_tree(runs):
    """The mesh_model-2 checkpoint has the one-process checkpoint's names
    and shapes, parameters and moments alike."""
    full = _mains_of(runs)[0][MAIN_JOBS["quality"]]
    one = runs[3]["quality"]
    a = torch.load(Path(full["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    b = torch.load(Path(one["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    for key in ("params", "mu", "nu"):
        x = a["params"] if key == "params" else a["opt_state"][key]
        y = b["params"] if key == "params" else b["opt_state"][key]
        assert {k: tuple(v.shape) for k, v in x.items()} == \
            {k: tuple(v.shape) for k, v in y.items()}, key
    assert tuple(a["params"]["video_encoder.backbone.block0.attn.qkv.weight"].shape) == (96, 32)


def test_checkpoints_restore_across_mesh_model(runs):
    """The world-1 run's epoch-0 checkpoint resumed at mesh_model 2, and the
    mesh_model-2 run's resumed at world 1: epoch 1 as the uninterrupted
    runs have it."""
    ranks = _mains_of(runs)
    from_one = [m[MAIN_JOBS["from_one"]] for m in ranks]
    one, two_full = runs[3], ranks[0][MAIN_JOBS["quality"]]
    for r in from_one:
        assert [h["epoch"] for h in r["history"]] == [1]
        np.testing.assert_allclose(r["history"][0]["loss"], one["quality"]["history"][1]["loss"],
                                   rtol=RUN_RTOL)
    h = one["from_two"]["history"]
    assert [e["epoch"] for e in h] == [1]
    np.testing.assert_allclose(h[0]["loss"], two_full["history"][1]["loss"], rtol=RUN_RTOL)
    np.testing.assert_allclose(h[0]["val_loss"], two_full["history"][1]["val_loss"],
                               rtol=RUN_RTOL)


def test_warm_start_from_a_port_checkpoint_at_model_2(runs):
    """``init_from_checkpoint`` of a whole ``.pt`` into the cut models: the
    one-epoch run at mesh_model 2 as the one-process run from the same file,
    and not as the cold run."""
    warm = [m[MAIN_JOBS["warm"]]["history"][0] for m in _mains_of(runs)]
    want = runs[3]["warm"]["history"][0]
    cold = _mains_of(runs)[0][MAIN_JOBS["quality"]]["history"][0]
    for h in warm:
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(h[k], want[k], rtol=RUN_RTOL, err_msg=k)
        assert abs(h["loss"] - cold["loss"]) > 1e3 * RUN_RTOL * abs(cold["loss"])


def test_rank_0_alone_writes(runs):
    written = [m[-1]["written"] for m in _mains_of(runs)]
    assert written[0] and not written[1]
