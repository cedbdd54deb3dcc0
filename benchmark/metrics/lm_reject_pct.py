"""Share of the LM steps that were rejected: the program's
``ba_soa.rejected_step`` spans over its ``ba_soa.solve_step`` spans.  A
program without the LM loop's host-read spans (``ba_soa.host_read``,
added with the rejected-step span) cannot tell a step it rejected, so its
slice reads nothing."""


def read(sl):
    steps = sl.span_count("ba_soa.solve_step")
    if not steps or not sl.ops or not sl.span_count("ba_soa.host_read"):
        return None
    return 100.0 * sl.span_count("ba_soa.rejected_step") / steps
