"""Per-patient properties of a preprocessed dataset.

The port's own copy of ``save_properties`` / ``load_properties``
(``medical_image_generation_tpu/planning/preprocess.py:225-233``): one
pickle a patient beside its volume, holding ``class_locations`` (sampled
foreground voxels, which the patch sampler's foreground oversampling reads)
and the intensity ``min_max``. The rest of preprocessing (resampling,
cropping, normalisation, the ``medimgen_plan_and_preprocess`` CLI) is not
ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict


def save_properties(data_path: str, patient_id: str, properties: Dict) -> None:
    """Per-patient properties pickle (reference configuration.py:1030-1034)."""
    with open(os.path.join(data_path, f"{patient_id}.pkl"), "wb") as f:
        pickle.dump(properties, f)


def load_properties(data_path: str, patient_id: str) -> Dict:
    with open(os.path.join(data_path, f"{patient_id}.pkl"), "rb") as f:
        return pickle.load(f)
