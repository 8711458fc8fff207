"""crypto_roofline.<mix>: the traced steps' least cryptographic work
(paillier_bench.leastwork: schoolbook operations from the sizes alone, at
the published int8 peak) as a share of the device's busy time over those
steps, in %."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not t.least_s:
        return None
    return 100.0 * t.least_s / t.busy_s
