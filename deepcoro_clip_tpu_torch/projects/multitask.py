"""Multitask pretraining project: builds the ``MultitaskRunner`` and runs
it (``train`` with resume, any other ``run_mode`` a validation pass). The
port's copy of the JAX package's ``projects/multitask.py``."""

from __future__ import annotations

from typing import Any, Dict

import deepcoro_clip_tpu_torch.runners.multitask  # noqa: F401  (registers the runner)
from deepcoro_clip_tpu_torch.projects.base import BaseProject
from deepcoro_clip_tpu_torch.registry import ProjectRegistry, RunnerRegistry


@ProjectRegistry.register("DeepCORO_multitask")
class MultitaskPretrainingProject(BaseProject):
    def run(self) -> Dict[str, Any]:
        output_dir = self._setup_project()
        runner = RunnerRegistry.get(self.config.pipeline_project)(self.config,
                                                                 output_dir=output_dir)
        self._backup_resolved()
        if self.config.run_mode == "train":
            result = runner.train(start_epoch=runner.maybe_resume())
        else:
            result = runner.validate()
        runner.logger.finish()
        return result
