"""Share of the card's bf16 peak that MAISI's train step's operations take:
the U-Net's operations in one step (counted on the meta device with the plain
reference, recomputation not counted) over the untraced window's time a
step; the formula of ``mfu.train``."""


def read(r):
    return 100.0 * r.flops / (r.step_s * r.peak["bf16_flops"])
