"""Linear-probing project: builds the ``LinearProbingRunner`` and dispatches
on ``run_mode`` (``train`` with resume, ``val`` / ``test`` a validation
pass with the bootstrap intervals, ``inference`` the predictions and study
embeddings). The port's copy of the JAX package's
``projects/linear_probing.py``."""

from __future__ import annotations

from typing import Any, Dict

import deepcoro_clip_tpu_torch.runners.linear_probing  # noqa: F401  (registers the runner)
from deepcoro_clip_tpu_torch.projects.base import BaseProject
from deepcoro_clip_tpu_torch.registry import ProjectRegistry, RunnerRegistry


@ProjectRegistry.register("DeepCORO_video_linear_probing")
class LinearProbingProject(BaseProject):
    def run(self) -> Dict[str, Any]:
        output_dir = self._setup_project()
        runner = RunnerRegistry.get(self.config.pipeline_project)(self.config,
                                                                 output_dir=output_dir)
        self._backup_resolved()
        mode = self.config.run_mode
        if mode == "train":
            result = runner.train(start_epoch=runner.maybe_resume())
        elif mode in ("val", "test"):
            result = runner.validate(split=mode)
        elif mode == "inference":
            result = {"rows": len(runner.inference())}
        else:
            raise ValueError(f"unknown run_mode {mode!r}")
        runner.logger.finish()
        return result
