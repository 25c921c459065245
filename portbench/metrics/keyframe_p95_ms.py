"""keyframe_p95_ms: for every keyframe due in the window, its due time until
its descriptor is in the DB and its detection has been drained. A keyframe
shed or never drained counts as beyond the tail. p95 by nearest rank; none
when the lost keyframes reach into the 95th percentile."""

import math

from portbench.yardstick import percentile


def read(ctx):
    v = percentile(ctx.run.keyframe_ms, 0.95)
    return None if v is None or math.isinf(v) else v
