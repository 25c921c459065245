"""decision_p90_ms: for every loop candidate raised from a keyframe due in
the window, its keyframe's due time until the candidate is accepted or
rejected; a candidate undecided when the window ends counts at its age
then. The highest percentile up to the 90th with ten samples beyond it
(yardstick.tail)."""

from portbench.yardstick import tail


def read(ctx):
    return tail(ctx.run.decision_ms, 0.90, beyond=10)
