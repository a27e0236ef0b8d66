"""Shared by ``tests/test_torch_single_head.py`` and ``tests/test_torch_locca.py``:
a rendered corpus with its SigLIP manifests, ``siglip_single_head_config.yaml``
at tiny widths on them, and one run of it through both packages' ``main``."""

from pathlib import Path

import jax
import numpy as np
import yaml

from deepcoro_clip_tpu.main import main as jax_main
from deepcoro_clip_tpu.runners.contrastive import VideoContrastiveLearningRunner as JaxRunner
from deepcoro_clip_tpu.train import clip as jclip

import chip_smoke
from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data import dataset_creation as tcreate
from deepcoro_clip_tpu_torch.data.synthetic_angio import generate_corpus
from deepcoro_clip_tpu_torch.main import main
from deepcoro_clip_tpu_torch.runners import contrastive as trun

REPO = Path(__file__).resolve().parents[1]
SINGLE_HEAD_YAML = REPO / "config" / "clip" / "siglip_single_head_config.yaml"
# the LocCa head at tiny widths; locca_enabled is the one switch
LOCCA_RUN = dict(locca_enabled=True, locca_d_model=16, locca_num_layers=1,
                 locca_num_heads=2, locca_max_seq_len=24)
EPOCH_KEYS = ("loss", "alignment", "temperature", "grad_norm", "grad_norm_video_encoder",
              "grad_norm_text_encoder", "lr", "val_loss", "val_alignment", "val_MRR",
              "val_Recall@1", "val_Recall@5")


def siglip_corpus(root: Path, seed: int, n_train: int = 12, n_val: int = 6) -> dict:
    """A rendered corpus of 4 x 32 x 32 clips and the SigLIP manifests the
    port's ``build_siglip_manifests`` writes from its findings."""
    manifest = generate_corpus(root / "corpus", n_train=n_train, n_val=n_val, size=32,
                               frames=4, seed=seed)
    rows = chip_smoke.siglip_rows(manifest, seed=seed)
    paths = tcreate.build_siglip_manifests(rows, root / "manifests",
                                           cto_columns=chip_smoke.siglip_cto_columns())
    return {"root": root, "paths": paths, "manifest": manifest, "rows": rows}


def single_head_yaml(paths, out: Path, **over) -> dict:
    """``siglip_single_head_config.yaml`` on the corpus's manifests, with
    the data paths, epochs, batch, workers and widths overridden (and the
    freeze ratios 0, so that every leaf of the tiny towers trains)."""
    cfg = yaml.safe_load(SINGLE_HEAD_YAML.read_text())
    cfg.update(
        data_filename=str(paths["videos"]), siglip_texts_path=str(paths["texts"]),
        siglip_edges_path=str(paths["edges"]), output_dir=str(out), epochs=2, batch_size=4,
        num_workers=2, frames=4, resize=32, vit_dim=32, vit_depth=1, vit_heads=1,
        vit_pool_stages=[], text_dim=32, text_depth=1, text_heads=2, max_text_length=16,
        embedding_dim=16, num_heads=2, siglip_max_positive_per_video=2,
        siglip_negatives_per_video=6, dropout=0.0, lr=1e-3, precision="fp32",
        use_pallas_attention=False, recall_k=[1, 5], ndcg_k=[5], mesh_data=-1, mesh_model=1,
        video_freeze_ratio=0.0, text_freeze_ratio=0.0)
    cfg.update(over)
    return cfg


def run_both_mains(root: Path, cfg: dict, monkeypatch):
    """``cfg`` as a YAML through the JAX ``main`` (its runner's initial tree
    written out, the text projection's dropout off) and through the port's
    ``main`` from that tree (``init_from_checkpoint``): (JAX history, port
    history)."""
    path = root / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    init = root / "init.npz"
    jinit = JaxRunner.__init__

    def wrapped(self, *a, **kw):
        jinit(self, *a, **kw)
        self.bundle = self.bundle._replace(
            text_model=self.bundle.text_model.clone(proj_dropout=0.0))
        self.train_step = jclip.make_train_step(self.bundle)
        self.eval_step = jclip.make_eval_step(self.bundle)
        convert.save_params_npz(jax.tree_util.tree_map(np.asarray, self.state.params), init)

    monkeypatch.setattr(JaxRunner, "__init__", wrapped)
    jhist = jax_main(["--base_config", str(path)])["history"]
    monkeypatch.undo()
    tinit = trun.VideoContrastiveLearningRunner.__init__

    def twrapped(self, *a, **kw):
        tinit(self, *a, **kw)
        self.bundle.text_model.proj.dropout = 0.0

    monkeypatch.setattr(trun.VideoContrastiveLearningRunner, "__init__", twrapped)
    thist = main(["--base_config", str(path), "--device", "cpu",
                  "--init_from_checkpoint", str(init)])["history"]
    monkeypatch.undo()
    return jhist, thist
