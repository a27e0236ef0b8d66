"""Project base: the run directory, the config backup, the run itself.

The port's copy of the JAX package's ``projects/base.py``. A run writes
into a new ``{output_dir}/{pipeline_project}/{project}/{run_id}_{timestamp}``
directory, except that ``resume_training`` with ``checkpoint`` naming an
earlier run's directory (or its ``checkpoints/``) continues that run in its
own directory (the JAX package's main makes a new directory every time, so
there a run resumes only through the runner).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

from deepcoro_clip_tpu_torch.parallel.multihost import broadcast_from_host0
from deepcoro_clip_tpu_torch.utils.files import backup_config, generate_output_dir_name


class BaseProject:
    def __init__(self, config):
        self.config = config
        self.output_dir: Optional[Path] = None

    def _setup_project(self) -> Path:
        cfg = self.config
        if cfg.resume_training and cfg.checkpoint:
            run = Path(cfg.checkpoint)
            self.output_dir = run.parent if run.name == "checkpoints" else run
        else:
            # rank 0's name (a timestamp) on every rank
            self.output_dir = Path(broadcast_from_host0(str(generate_output_dir_name(cfg))))
        if cfg.is_ref_device:
            self.output_dir.mkdir(parents=True, exist_ok=True)
            backup_config(cfg, self.output_dir)
        return self.output_dir

    def _backup_resolved(self) -> None:
        """Refresh the backup after the runner is built, so that computed
        fields (the dataset statistics) are in it."""
        if self.output_dir is not None and self.config.is_ref_device:
            backup_config(self.config, self.output_dir)

    def run(self) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError
