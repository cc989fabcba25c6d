"""``benchmark/calibrate.py`` for a cell of the ``ldm_latent_train`` driver
(MAISI's ``maisi3d_train``): the same readings, with the driver's own planted
faults (``heads_merged``, ``cond_dropped``) beside ``faults.FAULTS`` and the
driver's ``attn_qk_gap`` in the float8 control's numbers too. Run from the
root of a checkout, on the card:

    python3 tools/calibrate_latent_cell.py --workload maisi3d_train \
        --first-seed 1900000000000 --seeds 16 --control 3 \
        --fault heads_merged:16 --fault cond_dropped:6 --fault unchanged:1 \
        --out build/calib_maisi.jsonl

Prints one JSON line a reading.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import calibrate, faults, harness, loop  # noqa: E402


def main(argv=None):
    drv = harness.load_module(harness.find([harness.BENCH_DIR], "drivers", "ldm_latent_train",
                                           ".py"), "driver")
    faults.FAULTS.update(drv.FAULTS)
    control = loop.control

    def with_attn(cell, driver, mode="fp8"):
        checks, low, ref = control(cell, driver, mode)
        return drv.attn_check(checks, low, ref, cell.work["limits"]), low, ref

    loop.control = with_attn
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
