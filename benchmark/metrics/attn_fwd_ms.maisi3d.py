"""Stream milliseconds a train step of the program's span
``medimgen.attention``: the attention blocks' forwards (GroupNorm, the QKV
projection, the flash forward, the output projection and the residual),
summed over the blocks. The span's CUDA events on the step's stream, at its
entry and exit, time what the block holds the stream, idle included; summed
over the profiled steps and divided by the ``medimgen.train_step`` spans,
which must number the profiled steps. None from a program without the span
or the recorder."""

SPAN = "medimgen.attention"


def read(r):
    try:
        from medical_image_generation_tpu_torch.utils.profiling import read as recorded
    except ImportError:
        return None
    spans = recorded()["spans"]
    n = spans.get("medimgen.train_step", {}).get("n", 0)
    s = spans.get(SPAN)
    if n == 0 or n != r.trace["steps"] or s is None or s["stream_s"] is None:
        return None
    return 1e3 * s["stream_s"] / n
