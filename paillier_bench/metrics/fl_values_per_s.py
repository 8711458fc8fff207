"""fl_values_per_s: client gradient coordinates aggregated and decrypted
per second: every coordinate of every client in the window's steps (all
whole, as the window closes at a step's end), over the window's
seconds."""


def read(run):
    if run.unit != "values" or not run.steps or run.window_s <= 0:
        return None
    return sum(s[3] for s in run.steps) / run.window_s
