"""Config loading for the port's CLIs (its own copy of the JAX package's
``config/run.py:load_config``)."""

from __future__ import annotations

import yaml


def load_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)
