"""``medimgen_torch_plan_and_preprocess``: the planning CLI of the port.

The port's own copy of ``medical_image_generation_tpu/planning/cli.py``
(:1-261; reference configuration.py:1529-1676): fingerprint the
TaskXXX_Name dataset -> optional low-quality screening -> per-patient
preprocessing into chunked-compressed volumes (a pool of spawned
processes) -> ``dataset.json`` -> derived ``{2D, 3D}`` training configs ->
batch-size selection -> ``medimgen_config.yaml``, whose text equals the
JAX CLI's for the same inputs when the probe is off.

The batch-size selection runs trial steps of the shipped AE step on the
card (``planning/memory.py``). Unlike the JAX CLI, which keeps the planner
defaults when its probe fails, a probe error raises; ``--no-memory-probe``
keeps the defaults, and a probe asked for on the CPU raises before any
work.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import yaml

from medical_image_generation_tpu_torch.io import volstore
from medical_image_generation_tpu_torch.planning.fingerprint import (
    calculate_dataset_fingerprint,
    calculate_median_spacing,
    process_pool,
)
from medical_image_generation_tpu_torch.planning.planner import (
    create_autoencoder_dict,
    create_config_dict,
    create_ddpm_dict,
    epochs_multiplier,
)
from medical_image_generation_tpu_torch.planning.preprocess import process_patient


def validate_channels(value: str) -> List[int]:
    try:
        parsed = [int(v) for v in value.strip("[]").replace(",", " ").split()]
        return parsed
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            "input_channels must be a list of integers, e.g. '0 1' or '[0,1]'"
        ) from e


def validate_lq_threshold(value: str):
    if value in ("otsu", "percentile"):
        return value
    try:
        return int(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            "lq_threshold must be 'otsu', 'percentile', an integer, or unset"
        ) from e


class FlowListDumper(yaml.SafeDumper):
    """YAML dumper: no anchors, lists in flow style — the reference's
    medimgen_config.yaml formatting (configuration.py:1659-1671)."""

    def ignore_aliases(self, data):
        return True


FlowListDumper.add_representer(
    list,
    lambda dumper, data: dumper.represent_sequence(
        "tag:yaml.org,2002:seq", data, flow_style=True
    ),
)
FlowListDumper.add_representer(
    tuple,
    lambda dumper, data: dumper.represent_sequence(
        "tag:yaml.org,2002:seq", list(data), flow_style=True
    ),
)


def _process_patient_star(args):
    return process_patient(*args)


def plan_and_preprocess(
    dataset_path: str,
    input_channels: Optional[List[int]] = None,
    lq_threshold=None,
    preprocessed_root: Optional[str] = None,
    max_workers: Optional[int] = None,
    probe_memory: bool = True,
    device="cuda",
) -> str:
    """Run the full pipeline; returns the preprocessed dataset directory.
    ``probe_memory`` measures the batch on ``device``, which must be a
    card."""
    if probe_memory:
        from medical_image_generation_tpu_torch.planning.memory import require_card

        require_card(device)  # before any work: the probe needs the card
    dataset_path = dataset_path.rstrip("/")
    images_path = os.path.join(dataset_path, "imagesTr")
    labels_path = os.path.join(dataset_path, "labelsTr")

    basename = os.path.basename(dataset_path)
    dataset_id = basename.split("_")[0][4:]
    formatted_task_number = f"{int(dataset_id):03d}"
    standardized_name = f"Task{formatted_task_number}_" + "_".join(basename.split("_")[1:])

    preprocessed_root = preprocessed_root or os.getenv("medimgen_preprocessed")
    if not preprocessed_root:
        raise EnvironmentError("set the 'medimgen_preprocessed' environment variable")
    dataset_save_path = os.path.join(preprocessed_root, standardized_name)
    if os.path.exists(dataset_save_path):
        raise FileExistsError(f"Dataset {basename} already exists at {dataset_save_path}.")

    images_save_path = os.path.join(dataset_save_path, "imagesTr")
    labels_save_path = os.path.join(dataset_save_path, "labelsTr")
    os.makedirs(images_save_path, exist_ok=True)
    os.makedirs(labels_save_path, exist_ok=True)

    image_paths = sorted(glob.glob(os.path.join(images_path, "*.nii.gz")))
    patient_ids = [os.path.basename(p).replace(".nii.gz", "") for p in image_paths]
    print(f"\nNumber of patients: {len(patient_ids)}")

    print("\nCalculating median voxel spacing of the whole dataset...")
    median_spacing = calculate_median_spacing(image_paths)

    print("Fingerprinting shapes, intensity ranges, and image quality...")
    (
        median_shape,
        min_shape,
        max_shape,
        channel_min,
        channel_max,
        quality_dicts,
    ) = calculate_dataset_fingerprint(
        image_paths, median_spacing, input_channels, lq_threshold, max_workers=max_workers
    )
    print(f"\nMedian voxel spacing: {median_spacing}")
    print(f"Median Shape: {median_shape}")
    print(f"Min Shape: {min_shape}")
    print(f"Max Shape: {max_shape}")
    print(f"Min per channel: {channel_min}")
    print(f"Max per channel: {channel_max}")

    if lq_threshold is not None:
        n_low = int(np.sum([not q["pass"] for q in quality_dicts]))
        print(f"\nNumber of low quality images: {n_low}")
        image_paths = [p for p, q in zip(image_paths, quality_dicts) if q["pass"]]
        patient_ids = sorted(
            os.path.basename(p).replace(".nii.gz", "") for p in image_paths
        )
        print(f"Number of final patients: {len(patient_ids)}\n")

    median_shape_w_channel = median_shape
    median_shape, min_shape, max_shape = median_shape[1:], min_shape[1:], max_shape[1:]

    volstore.codec_in_use()  # build the native codec once, before the workers need it
    args_list = [
        (pid, images_path, labels_path, images_save_path, labels_save_path,
         median_spacing, median_shape)
        for pid in patient_ids
    ]
    results = []
    if max_workers == 0 or len(args_list) <= 2:
        for a in args_list:
            r = _process_patient_star(a)
            print(r["log"])
            results.append(r)
    else:
        with process_pool(max_workers) as ex:
            for r in ex.map(_process_patient_star, args_list):
                print(r["log"])
                results.append(r)

    all_labels = sorted({lbl for r in results for lbl in r["labels"]})
    n_channels = median_shape_w_channel[0] if len(median_shape_w_channel) == 4 else 1

    dataset_config = {
        "median_shape": tuple(int(x) for x in median_shape),
        "min_shape": tuple(int(x) for x in min_shape),
        "max_shape": tuple(int(x) for x in max_shape),
        "median_spacing": [float(x) for x in median_spacing],
        "channel_mins": [float(x) for x in channel_min],
        "channel_maxs": [float(x) for x in channel_max],
        "n_classes": int(len(all_labels)),
        "class_labels": [int(c) for c in all_labels],
        "n_channels": int(n_channels),
        "n_patients": int(len(results)),
    }
    with open(os.path.join(dataset_save_path, "dataset.json"), "w") as f:
        json.dump(dataset_config, f, indent=4)
    print(f"\nDataset configuration file saved in {dataset_save_path}/dataset.json")

    print(f"\nConfiguring image generation parameters for Dataset ID: {formatted_task_number}")
    channels = (
        input_channels if input_channels is not None else list(range(dataset_config["n_channels"]))
    )
    print(f"Input channels: {channels}")
    multiplier = epochs_multiplier(dataset_config["n_patients"])

    vae_2d = create_autoencoder_dict(dataset_config, channels, spatial_dims=2)
    vae_3d = create_autoencoder_dict(dataset_config, channels, spatial_dims=3)
    ddpm_2d = create_ddpm_dict(dataset_config, spatial_dims=2)
    ddpm_3d = create_ddpm_dict(dataset_config, spatial_dims=3)
    config_2d = create_config_dict(dataset_config, channels, multiplier, vae_2d, ddpm_2d)
    config_3d = create_config_dict(dataset_config, channels, multiplier, vae_3d, ddpm_3d)

    if probe_memory:
        from medical_image_generation_tpu_torch.planning.memory import auto_select_hyperparams

        print("\nSelecting batch size / grad accumulation from trial steps on the card...")
        bs2, ga2, remat2, policy2 = auto_select_hyperparams(
            config_2d, "2d", init_batch_size=24, device=device
        )
        bs3, ga3, remat3, policy3 = auto_select_hyperparams(
            config_3d, "3d", init_batch_size=2, device=device
        )
        config_2d["ae_batch_size"], config_2d["grad_accumulate_step"] = bs2, ga2
        # the probed AE batch in 2D, twice it in 3D: the JAX CLI's choices
        # (cli.py:216, :220), though the planner's default is twice in both
        config_2d["ddpm_batch_size"] = bs2
        config_2d["vae_params"]["use_checkpointing"] = remat2
        config_2d["vae_params"]["remat_policy"] = policy2
        config_3d["ae_batch_size"], config_3d["grad_accumulate_step"] = bs3, ga3
        config_3d["ddpm_batch_size"] = bs3 * 2
        config_3d["vae_params"]["use_checkpointing"] = remat3
        config_3d["vae_params"]["remat_policy"] = policy3

    config = {"2D": config_2d, "3D": config_3d}
    config_save_path = os.path.join(dataset_save_path, "medimgen_config.yaml")
    with open(config_save_path, "w") as f:
        yaml.dump(config, f, sort_keys=False, Dumper=FlowListDumper)
    print(f"Experiment configuration file saved at {config_save_path}")
    return dataset_save_path


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="Preprocess dataset and create configuration file."
    )
    parser.add_argument("dataset_path", type=str, help="Path to TaskXXX_Name dataset folder")
    parser.add_argument(
        "-c", "--input_channels", required=False, type=validate_channels, default=None,
        help="Input channel indexes to use (default: all).",
    )
    parser.add_argument(
        "-lqt", "--lq_threshold", required=False, type=validate_lq_threshold, default=None,
        help="Laplacian-variance threshold for screening: 'otsu', 'percentile', or an integer.",
    )
    parser.add_argument(
        "--no-memory-probe", action="store_true",
        help="Skip the batch-size selection by trial steps on the card (use planner defaults).",
    )
    args = parser.parse_args(argv)
    plan_and_preprocess(
        args.dataset_path,
        input_channels=args.input_channels,
        lq_threshold=args.lq_threshold,
        probe_memory=not args.no_memory_probe,
    )


if __name__ == "__main__":
    main()
