"""Host-blocking CUDA calls a train step: the program's counter
``host_syncs`` (the blocking copies between host and card, reads of device
values and stream synchronises inside ``medimgen.train_step`` that torch's
sync debug mode flags), over the profiled steps, divided by the
``medimgen.train_step`` spans, which must number the profiled steps. None
from a program without the recorder."""


def read(r):
    try:
        from medical_image_generation_tpu_torch.utils.profiling import read as recorded
    except ImportError:
        return None
    rec = recorded()
    n = rec["spans"].get("medimgen.train_step", {}).get("n", 0)
    if n == 0 or n != r.trace["steps"] or "host_syncs" not in rec["counters"]:
        return None
    return rec["counters"]["host_syncs"] / n
