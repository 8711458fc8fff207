"""launches_per_step.<mix>: the port's kernel launches (the counters
cuda_modexp.launches and cuda_rns.launches, which count a graph replay's
launches as its capture recorded them) per traced step."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.launches:
        return None
    return sum(t.launches.values()) / t.steps
