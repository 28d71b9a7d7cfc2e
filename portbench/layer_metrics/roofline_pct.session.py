"""The least time of the session cell's stages over their device busy
time, in percent: ``portbench.roofline_session``, which counts the links'
live positions (history and packet bytes), not the padded rows."""

from portbench import roofline_session


def read(run):
    if run.view is None:
        return None
    busy = run.view.busy_s(set(run.stages))
    if busy <= 0:
        return None
    least = sum(roofline_session.least_seconds(s, run.sizes)
                for s in run.stages)
    return 100.0 * least * run.view.ncalls / busy
