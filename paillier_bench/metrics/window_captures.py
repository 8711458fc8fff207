"""window_captures.<mix>: device-program calls inside the window that
replayed no graph: keys first called (run eagerly) and graphs captured.
Each is a shape that set-up did not warm; the run pays it in the window.
"""


def read(run):
    if not run.steps:
        return None
    return float(run.new_keys + run.new_graphs)
