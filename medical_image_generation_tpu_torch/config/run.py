"""Config plumbing, run directories, and logging.

The port's own copy of ``medical_image_generation_tpu/config/run.py``
(:27-244): the reference's layered config system (configuration.py:224-525)
and artifact contract: per-run directory holding ``config.yaml``,
``checkpoints/``, ``plots/``, optional ``log_file.txt`` with stdout/stderr
redirected into it, and the env-var path resolution
(``medimgen_preprocessed`` / ``medimgen_results``,
train_autoencoder.py:747-770). Two differences: resume reads
``checkpoints/last_model.pt`` (the port's checkpoints are ``.pt`` files),
and ``apply_overrides`` raises on a typo inside an existing dict.
"""

from __future__ import annotations

import glob
import logging
import os
import sys
from typing import Dict, Optional, Tuple

import yaml


def load_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def resolve_preprocessed_dataset(dataset_id: str, preprocessed_root: Optional[str] = None) -> str:
    root = preprocessed_root or os.getenv("medimgen_preprocessed")
    if not root:
        raise EnvironmentError("set the 'medimgen_preprocessed' environment variable")
    matches = glob.glob(os.path.join(root, f"Task{dataset_id}*/"))
    if not matches:
        raise FileNotFoundError(f"no preprocessed dataset Task{dataset_id}* under {root}")
    return matches[0].rstrip("/")


def get_config_for_current_task(
    dataset_id: str,
    model_type: str,
    model_name: str,
    progress_bar: bool = False,
    continue_training: bool = False,
    preprocessed_root: Optional[str] = None,
    results_root: Optional[str] = None,
    initial_config: Optional[dict] = None,
) -> dict:
    """Resolve the generated medimgen_config.yaml for a dataset and wire the
    run paths (reference train_autoencoder.py:747-770).

    model_name: 'autoencoder' | 'ldm' | 'ddpm' — results subdirectory.
    """
    ds_path = resolve_preprocessed_dataset(dataset_id, preprocessed_root)
    if initial_config is None:
        config_path = os.path.join(ds_path, "medimgen_config.yaml")
        if not os.path.exists(config_path):
            raise FileNotFoundError(
                f"No medimgen configuration for Dataset {dataset_id}. "
                "First run: medimgen_plan_and_preprocess"
            )
        config = load_config(config_path)
    else:
        config = initial_config

    config = config["2D"] if model_type == "2d" else config["3D"]
    config["progress_bar"] = progress_bar
    config["output_mode"] = config.get("output_mode", "verbose")
    config["task"] = os.path.basename(ds_path)
    config["dataset_id"] = dataset_id
    config["model_type"] = model_type

    results_root = results_root or os.getenv("medimgen_results")
    if not results_root:
        raise EnvironmentError("set the 'medimgen_results' environment variable")
    results_path = os.path.join(results_root, os.path.basename(ds_path), model_type, model_name)
    if os.path.exists(results_path) and not continue_training:
        raise FileExistsError(f"Results path {results_path} already exists.")
    config["results_path"] = results_path
    last = os.path.join(results_path, "checkpoints", "last_model.pt")
    config["load_model_path"] = last if continue_training else None
    return config


def create_save_path_dict(config: dict) -> Tuple[Dict[str, str], str]:
    """Create the run directory tree and snapshot the config
    (reference configuration.py:377-401). Unlike the reference's timestamped
    dirs, the run dir is the stable results_path so resume paths don't move;
    each (re)start snapshots config.yaml."""
    save_path = config["results_path"]
    os.makedirs(save_path, exist_ok=True)

    if config.get("output_mode") == "log":
        setup_logging(os.path.join(save_path, "log_file.txt"))

    snapshot = {k: v for k, v in config.items() if k not in ("progress_bar",)}
    with open(os.path.join(save_path, "config.yaml"), "w") as f:
        yaml.dump(snapshot, f, default_flow_style=False, sort_keys=False)

    save_dict = {
        "checkpoints": os.path.join(save_path, "checkpoints"),
        "plots": os.path.join(save_path, "plots"),
    }
    for p in save_dict.values():
        os.makedirs(p, exist_ok=True)
    return save_dict, save_path


def filter_config_by_mode(config: dict, args_mode: str) -> dict:
    """Drop keys irrelevant to the mode (reference configuration.py:329-374)."""
    config = dict(config)
    if args_mode == "train_ddpm":
        for key in ("latent_space_type", "vae_params", "kl_weight", "vqvae_params",
                    "q_weight", "load_autoencoder_path"):
            config.pop(key, None)
        # pixel-space DDPM uses its own schedule (reference train_ddpm.py:
        # 380-381: linear_beta 0.0005->0.0195), not the LDM's scaled-linear
        # ramp; the planner emits it as ddpm_time_scheduler_params
        if config.get("ddpm_time_scheduler_params"):
            config["time_scheduler_params"] = config["ddpm_time_scheduler_params"]
    else:
        config.pop("ddpm_time_scheduler_params", None)
    if args_mode == "train_ddpm":
        config.pop("ddpm_time_scheduler_params", None)
    if args_mode == "train_autoencoder":
        for key in ("ddpm_params", "time_scheduler_params", "ddpm_learning_rate",
                    "load_autoencoder_path"):
            config.pop(key, None)
    if args_mode in ("train_ddpm", "train_ldm"):
        for key in ("g_learning_rate", "d_learning_rate", "q_weight", "kl_weight",
                    "adv_weight", "perc_weight", "autoencoder_warm_up_epochs",
                    "perceptual_params", "discriminator_params"):
            config.pop(key, None)
    if args_mode in ("train_autoencoder", "train_ldm"):
        latent = config.get("latent_space_type", "vae").lower()
        if latent == "vq":
            # the planner only emits vae_params; the VQ models reuse its
            # geometry when no explicit vqvae_params is given — keep it then
            if config.get("vqvae_params"):
                config.pop("vae_params", None)
            config.pop("kl_weight", None)
        else:
            config.pop("vqvae_params", None)
            config.pop("q_weight", None)
    return config


def apply_overrides(config: dict, overrides) -> dict:
    """Apply ``--set dotted.key=value`` CLI overrides onto the generated
    config — the capability of the reference's per-field CLI override layer
    (configuration.py:224-326, update_config_with_args) in one generic flag.

    Values parse as YAML (so numbers, bools, lists and strings all work);
    dots traverse nested dicts: ``--set vae_params.num_res_blocks=3``.

    All train CLIs apply overrides AFTER ``filter_config_by_mode``; an
    override whose top-level key is absent from the filtered config is
    applied but warned about — it either resurrects a key the mode dropped
    (which nothing will read) or is misspelled, or it is a legitimately new
    key (e.g. ``class_conditioning``). Unlike the JAX package
    (``config/run.py:171-182``, which creates the leaf silently), a dotted
    key whose parent dict exists but lacks the next key raises ``KeyError``:
    that is a typo inside a dict the run reads.
    """
    if not overrides:
        return config
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key=value")
        key, raw = item.split("=", 1)
        value = yaml.safe_load(raw)
        node = config
        parts = key.split(".")
        if parts[0] not in config:
            print(
                f"WARNING: --set {key}: {parts[0]!r} is not in the "
                "mode-filtered config — either this mode does not read it "
                "(mode filtering dropped it), it is misspelled, or it is a "
                "new optional key"
            )
        for depth, part in enumerate(parts[:-1]):
            if part not in node or not isinstance(node[part], dict):
                node[part] = {}
            elif parts[depth + 1] not in node[part]:
                raise KeyError(
                    f"--set {key}: {'.'.join(parts[:depth + 1])} has no key "
                    f"{parts[depth + 1]!r} (it has {sorted(node[part])})"
                )
            node = node[part]
        node[parts[-1]] = value
    return config


def print_configuration(config: dict, save_path: str, mode: str, model: Optional[str] = None,
                        space_from_start: int = 40) -> None:
    """Aligned configuration summary (reference configuration.py:404-453)."""

    def flatten(d, parent=""):
        items = {}
        for k, v in d.items():
            key = f"{parent}.{k}" if parent else k
            if isinstance(v, dict):
                items.update(flatten(v, key))
            else:
                items[key] = v
        return items

    flat = flatten(config)
    width = space_from_start * 3
    print("Configuration Summary".center(width))
    print("=" * width)
    print(f"Mode{' ' * (space_from_start - 4)}{mode}")
    if model:
        print(f"Model{' ' * (space_from_start - 5)}{model}")
    print(f"Task{' ' * (space_from_start - 4)}{config.get('task', '?')}")
    print(f"Save Path{' ' * (space_from_start - 9)}{save_path}")
    if model:
        print("\nParameters:\n" + "-" * width)
        for key, value in flat.items():
            if key in ("task", "results_path"):
                continue
            print(f"{key}{' ' * max(1, space_from_start - len(key))}{value}")
        print("=" * width)


class LoggerWriter:
    """Redirects stdout/stderr into logging (reference configuration.py:501-515)."""

    def __init__(self, logger, level):
        self.logger = logger
        self.level = level

    def write(self, message):
        if message.strip():
            self.logger.log(self.level, message.strip())

    def flush(self):
        pass


def setup_logging(log_file_path: str) -> None:
    """Send all output to a log file (reference configuration.py:469-498)."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    logger.handlers = []
    handler = logging.FileHandler(log_file_path, mode="a")
    handler.setFormatter(
        logging.Formatter("%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    )
    logger.addHandler(handler)
    sys.stdout = LoggerWriter(logger, logging.INFO)
    sys.stderr = LoggerWriter(logger, logging.ERROR)
