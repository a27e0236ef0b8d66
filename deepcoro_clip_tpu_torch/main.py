"""Entry point of the port: parse the config, seed, build the project of
its ``pipeline_project`` and run it.

    python -m deepcoro_clip_tpu_torch.main --base_config config/quality/flagship_quality_train.yaml \
        [--device cpu] [--any_config_field value ...]

The port's copy of the JAX package's ``main.py``. The run goes to the
card unless the config's ``device`` field (``--device cpu``, or
``device: cpu`` in the YAML) asks for the CPU; without CUDA nothing else
runs. ``main(config=...)`` takes a config object instead of arguments, for
callers without a YAML reader.

Under ``torch.distributed.run`` every rank runs ``main``, which starts the
process group first (``parallel/distributed.init_from_env``) and tears it
down at the end, also when the run raises, so that a failing rank ends the
launch with a non-zero exit::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepcoro_clip_tpu_torch.main --base_config <yaml> [--device cpu]

A group its caller started already is used and left running.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from deepcoro_clip_tpu_torch.parallel import distributed
from deepcoro_clip_tpu_torch.registry import ProjectRegistry, register_all
from deepcoro_clip_tpu_torch.utils.seed import set_seed


def main(argv: Optional[Sequence[str]] = None, config=None):
    register_all()
    if config is None:
        from deepcoro_clip_tpu_torch.configs import parse_config

        config = parse_config(argv)
    started = not torch.distributed.is_initialized()
    distributed.init_from_env(config.device)
    try:
        config.set_device_info_in_place()
        set_seed(config.seed)
        project = ProjectRegistry.get(config.pipeline_project)(config)
        result = project.run()
        if config.is_ref_device and isinstance(result, dict):
            printable = {k: v for k, v in result.items()
                         if isinstance(v, (int, float, str))}
            print(f"[deepcoro_clip_tpu_torch] done: {printable}")
        return result
    finally:
        if started:
            distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
