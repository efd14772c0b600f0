"""Mean ms from one request's ``lhn.serve`` exit event to the next one's
entry event on the device's stream, in the counted profiled stretch: the
answer's copy to the host and the client's turn."""

from perfbench.core.spans import request_gap_ms


def read(run):
    return request_gap_ms(run)
