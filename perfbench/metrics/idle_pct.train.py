"""Share of a call's time in which no kernel or copy ran on the device:
busy time per call from ``torch.profiler``'s device-only stretch, over the
unprofiled window's time per call."""

from perfbench.core.readers import idle_pct


def read(run):
    return idle_pct(run)
