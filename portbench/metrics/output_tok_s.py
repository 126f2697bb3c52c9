"""Output tokens that reached the host in the window, over the window's wall
seconds (a token is stamped when the step that made it returns)."""
from portbench import yardstick


def read(run):
    return yardstick.output_tokens((r.stamps for r in run.reqs), run.end) / run.end
