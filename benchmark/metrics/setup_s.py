"""``setup_s``: seconds from the process's start to the first timed step
or request (imports, data, weights, the kernel build on a first run,
warm-up and, for training, the recorded first steps)."""


def read(rec):
    return rec.get("setup_s")
