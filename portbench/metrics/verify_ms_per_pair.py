"""verify_ms_per_pair.<cells>: host milliseconds inside verify_pending in the
window over the pairs it decided (accepted or rejected, tier 1 and tier 2
together)."""

from portbench.readers import verify_ms_per_pair


def read(ctx):
    return verify_ms_per_pair(ctx)
