"""Mean host ms of the program's span ``lhn.serve.forward`` per request: the
host's time to enqueue the graph. At or above ``forward_ms.serve`` the
forward is launch-bound."""

from perfbench.core.spans import mean_ms


def read(run):
    return mean_ms(run, "lhn.serve.forward", clock="host")
