"""``penalty_ms_per_step.wgan_train``: per WGAN step, the device time of
the operations launched inside the port's ``train.penalty`` spans (the
critic on the interpolate and its input gradient with ``create_graph``) and
inside the critic substeps' ``train.backward``; ``common/launches.py``.
That backward is one ``autograd.grad`` of the whole critic loss, so the
number holds the plain backward of the two WGAN terms, D(fake) and D(x),
beside the double backward through the penalty: it is an upper bound on
the penalty's own time, which only a span of its own would part out.
None on a port without those spans."""

from benchmark.common.launches import launched_ms_per_unit, program_spans


def read(rec):
    if rec.get("mix") != "wgan_train":
        return None
    penalty = program_spans(rec, "train.penalty")
    if not penalty:
        return None
    spans = rec["program_spans"]
    critic = [s for s in program_spans(rec, "train.backward")
              if s["parent"] is not None
              and spans[s["parent"]]["name"] == "train.substep"
              and spans[s["parent"]].get("group") == "disc"]
    return launched_ms_per_unit(rec, penalty + critic)
