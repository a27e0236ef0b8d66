"""The port imports neither JAX nor anything of the JAX package.

Run in a subprocess: this test process has JAX loaded already
(tests/conftest.py imports it). There ``jax``, ``flax`` and ``optax``
(and ``yaml``, ``pandas`` and ``cv2``, which the machine with the card
need not have) are made unimportable, every module of
``deepcoro_clip_tpu_torch``, ``chip_smoke`` and the ranks of the
data-parallel and process-group ring tests (``tests/test_torch_ddp_workers.py``,
``tests/test_torch_ring_workers.py``) is imported, and no
``deepcoro_clip_tpu`` module may have been loaded.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHECK = """
import importlib, pkgutil, sys
# yaml, pandas and cv2 too: the machine with the card need not have them;
# only configs.parse_config (yaml) and video_io._decode_container (cv2) may
# ask for one, inside the call
for name in ("jax", "jaxlib", "flax", "optax", "yaml", "pandas", "cv2"):
    sys.modules[name] = None  # any import of them now raises ImportError
import deepcoro_clip_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(deepcoro_clip_tpu_torch.__path__,
                                               "deepcoro_clip_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
import tests.test_torch_ddp_workers  # the data-parallel tests' ranks
import tests.test_torch_ring_workers  # the process-group ring tests' ranks
import tests.test_torch_tp_workers  # the tensor-parallel tests' ranks
bad = sorted(m for m in sys.modules
             if m == "deepcoro_clip_tpu" or m.startswith("deepcoro_clip_tpu."))
assert not bad, bad
for need in ("train.clip", "train.optim", "losses.contrastive", "models.text_encoder",
             "train.linear_probe", "models.mil", "models.attention_pool", "losses.heads",
             "parallel.mesh", "parallel.ring_attention", "ops._ring_cuda",
             "main", "registry", "projects.base", "projects.contrastive",
             "runners.common", "runners.contrastive", "train.checkpoint",
             "train.run_schedules", "data.tokenizer", "data.csv_utils", "data.datasets",
             "data.collate", "data.sampler", "data.loader", "data.synthetic_angio",
             "data.randaugment", "utils.retrieval_metrics", "utils.logging_utils",
             "utils.seed", "utils.files", "models.captioning_decoder",
             "models.masked_video_modeling", "losses.multitask", "losses.locca",
             "data.locca", "train.multitask", "runners.multitask", "projects.multitask",
             "utils.caption_metrics", "utils.stenosis_extractor", "data.siglip",
             "data.siglip_runtime", "data.dataset_creation", "utils.semantic_metrics",
             "utils.siglip_logging", "utils.metrics", "runners.linear_probing",
             "projects.linear_probing", "generate_embeddings", "ops.library", "serving",
             "export_model", "external_validation", "data.single_head_sampler",
             "models.locca_decoder", "parallel.distributed", "parallel.batching",
             "parallel.multihost", "utils.hf_import", "utils.torch_import",
             "convert_checkpoint", "train.state", "models.layers", "convert"):
    assert "deepcoro_clip_tpu_torch." + need in mods, need
print(len(mods))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 82  # every module walked
