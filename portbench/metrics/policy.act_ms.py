"""policy.act_ms (layer: policy, ``models/rlmil.py`` ``act``: the policy's
forward, its noise drawn on the host and moved to the card, the clamp and
the log-prob; 2(T-1) calls a stage-3 step): the host's time a step inside
the program's ``murcl.policy`` spans, on the profiler's clock, in ms; None
where the program opens no such span. Moves slides_per_s."""


def read(run):
    spans = [e for e in run.host if e.name == "murcl.policy"]
    if not spans:
        return None
    return sum(e.time_range.end - e.time_range.start for e in spans) / 1e3 / run.steps
