"""Contrastive pretraining project: builds the runner and dispatches on
``run_mode`` (``train`` with resume, ``val``/``test``). The port's copy of
the JAX package's ``projects/contrastive.py``; ``inference`` raises
``NotImplementedError`` in the runner."""

from __future__ import annotations

from typing import Any, Dict

import deepcoro_clip_tpu_torch.runners.contrastive  # noqa: F401  (registers the runner)
from deepcoro_clip_tpu_torch.projects.base import BaseProject
from deepcoro_clip_tpu_torch.registry import ProjectRegistry, RunnerRegistry


@ProjectRegistry.register("DeepCORO_clip", "DeepCORO_clip_simple")
class ContrastivePretrainingProject(BaseProject):
    def run(self) -> Dict[str, Any]:
        output_dir = self._setup_project()
        runner = RunnerRegistry.get(self.config.pipeline_project)(self.config,
                                                                 output_dir=output_dir)
        self._backup_resolved()
        mode = self.config.run_mode
        if mode == "train":
            start = runner.maybe_resume()
            result = runner.train(start_epoch=start)
        elif mode in ("val", "test"):
            result = runner.validate(split=mode)
        else:
            raise ValueError(f"unknown run_mode {mode!r}")
        runner.logger.finish()
        return result
