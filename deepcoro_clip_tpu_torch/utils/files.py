"""Run-directory naming and the resolved-config backup.

The port's copy of the JAX package's ``utils/files.py``: a run writes into
``{output_dir}/{pipeline_project}/{project}/{run_id}_{timestamp}``, and the
fully resolved config is kept there as ``config.yaml``, written as JSON
(which YAML readers read) so that no YAML writer is needed.
"""

from __future__ import annotations

import time
import uuid
from pathlib import Path


def generate_run_id() -> str:
    return uuid.uuid4().hex[:8]


def generate_output_dir_name(config, run_id: str | None = None) -> Path:
    run_id = run_id or generate_run_id()
    ts = time.strftime("%Y%m%d-%H%M%S")
    return (
        Path(config.output_dir)
        / config.pipeline_project
        / (config.project or "default")
        / f"{run_id}_{ts}"
    )


def backup_config(config, output_dir: Path) -> Path:
    """Write the fully resolved config into the run dir."""
    path = Path(output_dir) / "config.yaml"
    config.save_json(path)
    return path
